"""ctypes bridge to the port's host C++ code (csrc/host/).

Two host libraries, each built with the host C++ compiler (`CXX`, default
`c++`) at first use into `_build/` next to this package and loaded with
ctypes. Unlike the JAX package's loader, a failed build raises: nothing
falls back quietly.

- `fused_filter_sum.cpp`: the fused filter + sum lane (`SET
  segment_strategy = 'native'`, runtime/executor.py
  `_try_native_scan_agg`), one pass of `sr_fused_filter_sum_i64_mt` over
  host int64 columns;
- `hash_partition.cpp`: `sr_hash_partition_i64_mt`, the splitmix64
  bucketing the spill executors route join inputs with
  (`hash_partition_i64`; runtime/batched.py), and the stable counting sort
  of rows by bucket (`bucket_order`). `hash_partition_i64_np` is the
  bucketing's plain numpy version, the reference's fallback, held to it
  bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from . import lockdep

_PKG = Path(__file__).resolve().parent
HOST_DIR = _PKG / "csrc" / "host"
SOURCE = HOST_DIR / "fused_filter_sum.cpp"
LIBS = ("fused_filter_sum", "hash_partition")
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

# compare-op tags shared with the C side (sr_fused_filter_sum_i64_mt)
FS_OPS = {"eq": 0, "ne": 1, "lt": 2, "le": 3, "gt": 4, "ge": 5}

_libs: dict = {}
_lock = lockdep.lock("native._lock")


def _lib_path(name: str) -> Path:
    src = HOST_DIR / f"{name}.cpp"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def build(name: str = "fused_filter_sum") -> Path:
    """Compile one host library unless it is built; raises on failure."""
    out = _lib_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "c++"), *CXX_FLAGS, "-o", str(tmp),
           str(HOST_DIR / f"{name}.cpp")]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"host library build failed:\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


def build_all() -> list:
    """Build every host library (chip_smoke's build phase)."""
    return [build(name) for name in LIBS]


def _load(name: str = "fused_filter_sum"):
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            p64 = ctypes.POINTER(ctypes.c_int64)
            if name == "fused_filter_sum":
                lib.sr_fused_filter_sum_i64_mt.argtypes = [
                    ctypes.POINTER(p64), ctypes.POINTER(ctypes.c_int32), p64,
                    ctypes.c_int32, p64, p64, ctypes.c_int64, p64, p64,
                    ctypes.c_int32,
                ]
                lib.sr_fused_filter_sum_i64_mt.restype = None
            else:
                p32 = ctypes.POINTER(ctypes.c_int32)
                lib.sr_hash_partition_i64_mt.argtypes = [
                    p64, ctypes.c_int64, ctypes.c_int32, p32, ctypes.c_int32,
                ]
                lib.sr_hash_partition_i64_mt.restype = None
                lib.sr_bucket_order_i32_mt.argtypes = [
                    p32, ctypes.c_int64, ctypes.c_int32, p64, p64,
                    ctypes.c_int32,
                ]
                lib.sr_bucket_order_i32_mt.restype = None
            _libs[name] = lib
        return lib


def hash_partition_i64(keys: np.ndarray, nbuckets: int) -> np.ndarray:
    """splitmix64 bucket of each int64 key, modulo `nbuckets`, as int32 (the
    host C++ function, on up to 8 threads)."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    lib = _load("hash_partition")
    out = np.empty(len(keys), dtype=np.int32)
    lib.sr_hash_partition_i64_mt(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(keys), int(nbuckets),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        min(os.cpu_count() or 1, 8),
    )
    return out


def bucket_order(bucket: np.ndarray, nbuckets: int):
    """(order, offsets): the row ids sorted stably by bucket (numpy's
    argsort(bucket, kind="stable")) and where each bucket starts in it
    ([nbuckets + 1]), by the host C++ counting sort on up to 8 threads.
    Every bucket id must lie in [0, nbuckets)."""
    bucket = np.ascontiguousarray(bucket, dtype=np.int32)
    lib = _load("hash_partition")
    order = np.empty(len(bucket), dtype=np.int64)
    offsets = np.empty(int(nbuckets) + 1, dtype=np.int64)
    p64 = ctypes.POINTER(ctypes.c_int64)
    lib.sr_bucket_order_i32_mt(
        bucket.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(bucket),
        int(nbuckets), order.ctypes.data_as(p64), offsets.ctypes.data_as(p64),
        min(os.cpu_count() or 1, 8))
    return order, offsets


def hash_partition_i64_np(keys: np.ndarray, nbuckets: int) -> np.ndarray:
    """The plain numpy version of `hash_partition_i64` (the reference's
    fallback, starrocks_tpu/native.py)."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    with np.errstate(over="ignore"):
        z = keys.view(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return (z % np.uint64(nbuckets)).astype(np.int32)


def fused_filter_sum_i64(pred_cols, pred_ops, pred_vals, a, b=None):
    """One-pass conjunctive filter + sum(a*b) (sum(a) when b is None) over
    int64 host columns of one length. Returns (total, match_count); the
    sum wraps mod 2^64 as the reference's does."""
    lib = _load("fused_filter_sum")
    cols = [np.ascontiguousarray(c, dtype=np.int64) for c in pred_cols]
    a = np.ascontiguousarray(a, dtype=np.int64)
    n = len(a)
    if any(len(c) != n for c in cols) or (b is not None and len(b) != n):
        raise ValueError("fused_filter_sum_i64: columns differ in length")
    if not (len(cols) == len(pred_ops) == len(pred_vals)):
        raise ValueError("fused_filter_sum_i64: one op and value per column")
    p64 = ctypes.POINTER(ctypes.c_int64)
    bp = None
    if b is not None:
        b = np.ascontiguousarray(b, dtype=np.int64)
        bp = b.ctypes.data_as(p64)
    k = len(cols)
    col_arr = (p64 * k)(*[c.ctypes.data_as(p64) for c in cols])
    op_arr = (ctypes.c_int32 * k)(*[int(o) for o in pred_ops])
    val_arr = (ctypes.c_int64 * k)(*[int(v) for v in pred_vals])
    out_sum = ctypes.c_int64(0)
    out_cnt = ctypes.c_int64(0)
    lib.sr_fused_filter_sum_i64_mt(
        col_arr, op_arr, val_arr, k, a.ctypes.data_as(p64), bp, n,
        ctypes.byref(out_sum), ctypes.byref(out_cnt),
        min(os.cpu_count() or 1, 8),
    )
    return int(out_sum.value), int(out_cnt.value)
