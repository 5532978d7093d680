"""ctypes bridge to the port's host C++ code (csrc/host/).

The fused filter + sum lane (`SET segment_strategy = 'native'`,
runtime/executor.py `_try_native_scan_agg`) runs one pass of
`sr_fused_filter_sum_i64_mt` over host int64 columns. The library is
built with the host C++ compiler (`CXX`, default `c++`) at first use into
`_build/` next to this package and loaded with ctypes. Unlike the JAX
package's loader, a failed build raises: the lane never falls back quietly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "host" / "fused_filter_sum.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

# compare-op tags shared with the C side (sr_fused_filter_sum_i64_mt)
FS_OPS = {"eq": 0, "ne": 1, "lt": 2, "le": 3, "gt": 4, "ge": 5}

_lib = None
_lock = threading.Lock()


def _lib_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libfused_filter_sum_{digest[:12]}.so"


def build() -> Path:
    """Compile the host library unless it is built; raises on failure."""
    out = _lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "c++"), *CXX_FLAGS, "-o", str(tmp),
           str(SOURCE)]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"host library build failed:\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p64 = ctypes.POINTER(ctypes.c_int64)
            lib.sr_fused_filter_sum_i64_mt.argtypes = [
                ctypes.POINTER(p64), ctypes.POINTER(ctypes.c_int32), p64,
                ctypes.c_int32, p64, p64, ctypes.c_int64, p64, p64,
                ctypes.c_int32,
            ]
            lib.sr_fused_filter_sum_i64_mt.restype = None
            _lib = lib
        return _lib


def fused_filter_sum_i64(pred_cols, pred_ops, pred_vals, a, b=None):
    """One-pass conjunctive filter + sum(a*b) (sum(a) when b is None) over
    int64 host columns of one length. Returns (total, match_count); the
    sum wraps mod 2^64 as the reference's does."""
    lib = _load()
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
