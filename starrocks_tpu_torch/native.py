"""ctypes bridge to the port's host C++ code (csrc/host/).

The host libraries, each built with the host C++ compiler (`CXX`, default
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
- `csv_parse.cpp`: `Session.load_csv`'s parser (`parse_csv`: the
  reference's unquoted lane, copied, and the port's RFC 4180 lane for
  quoted files), the loaders' bulk string dictionaries (`dict_encode`,
  `strings_at`) and the CSV writer of the tests and chip_smoke.py
  (`format_csv`);
- `file_formats.cpp`: the hot loops of the parquet and ORC readers
  (storage/formats/): snappy, the RLE/bit-packed hybrid, parquet's DELTA
  and BYTE_STREAM_SPLIT encodings, ORC's run-length encodings and the
  split of length-prefixed byte arrays; and the loops of the TabletStore's
  parquet writer (`snappy_compress`, `rle_hybrid_encode`,
  `dict_encode_fixed`, `plain_byte_arrays`);
- `zstd_decode.cpp`, `lz4_decode.cpp`, `brotli_decode.cpp` and
  `lzo_decode.cpp`: the ZSTD frame decoder (RFC 8878), the LZ4 block
  decoder, the Brotli decoder (RFC 7932; its static dictionary, transforms
  and context lookup in `brotli_tables.inc`, which the build's digest
  covers) and the LZO1X decoder (as the ORC library reads LZO) of the
  parquet and ORC codecs.
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
LIBS = ("fused_filter_sum", "hash_partition", "csv_parse", "file_formats",
        "zstd_decode", "lz4_decode", "brotli_decode", "lzo_decode")
# files a source includes beside it (their bytes are part of its digest)
INCLUDES = {"brotli_decode": ("brotli_tables.inc",)}
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

# compare-op tags shared with the C side (sr_fused_filter_sum_i64_mt)
FS_OPS = {"eq": 0, "ne": 1, "lt": 2, "le": 3, "gt": 4, "ge": 5}

_libs: dict = {}
_lock = lockdep.lock("native._lock")


def _lib_path(name: str) -> Path:
    src = HOST_DIR / f"{name}.cpp"
    h = hashlib.sha256(src.read_bytes() + " ".join(CXX_FLAGS).encode())
    for inc in INCLUDES.get(name, ()):
        h.update((HOST_DIR / inc).read_bytes())
    digest = h.hexdigest()
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
    """Build every host library (chip_smoke's build phase), one compiler
    process per source, all at once."""
    import concurrent.futures as cf

    with cf.ThreadPoolExecutor(len(LIBS)) as ex:
        return list(ex.map(build, LIBS))


def _sig_fused_filter_sum(lib):
    p64 = ctypes.POINTER(ctypes.c_int64)
    lib.sr_fused_filter_sum_i64_mt.argtypes = [
        ctypes.POINTER(p64), ctypes.POINTER(ctypes.c_int32), p64,
        ctypes.c_int32, p64, p64, ctypes.c_int64, p64, p64, ctypes.c_int32,
    ]
    lib.sr_fused_filter_sum_i64_mt.restype = None


def _sig_hash_partition(lib):
    p64 = ctypes.POINTER(ctypes.c_int64)
    p32 = ctypes.POINTER(ctypes.c_int32)
    lib.sr_hash_partition_i64_mt.argtypes = [
        p64, ctypes.c_int64, ctypes.c_int32, p32, ctypes.c_int32,
    ]
    lib.sr_hash_partition_i64_mt.restype = None
    lib.sr_bucket_order_i32_mt.argtypes = [
        p32, ctypes.c_int64, ctypes.c_int32, p64, p64, ctypes.c_int32,
    ]
    lib.sr_bucket_order_i32_mt.restype = None


def _sig_csv_parse(lib):
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.sr_csv_count_rows.argtypes = [vp, i64]
    lib.sr_csv_count_rows.restype = i64
    lib.sr_csv_parse.argtypes = [vp, i64, ctypes.c_char, i32, vp, vp, vp, i64]
    lib.sr_csv_parse.restype = i64
    lib.sr_csv_parse_quoted.argtypes = [vp, i64, ctypes.c_char, i32, vp, vp,
                                        vp, i64, vp]
    lib.sr_csv_parse_quoted.restype = i64
    lib.sr_dict_encode.argtypes = [vp, vp, i64, vp, vp, i32]
    lib.sr_dict_encode.restype = i64
    lib.sr_gather_fixed.argtypes = [vp, vp, vp, i64, i64, vp]
    lib.sr_gather_fixed.restype = None
    lib.sr_csv_format.argtypes = [i32, vp, vp, vp, vp, vp, vp, i64, i64,
                                  ctypes.c_char, vp, i64]
    lib.sr_csv_format.restype = i64


def _sig_file_formats(lib):
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.sr_snappy_decompress.argtypes = [vp, i64, vp, i64]
    lib.sr_snappy_decompress.restype = i64
    lib.sr_rle_bp_decode.argtypes = [vp, i64, i32, i64, vp]
    lib.sr_rle_bp_decode.restype = i64
    lib.sr_byte_array_offsets.argtypes = [vp, i64, i64, i64, vp]
    lib.sr_byte_array_offsets.restype = i64
    lib.sr_orc_rle_v2.argtypes = [vp, i64, i32, i64, vp]
    lib.sr_orc_rle_v2.restype = i64
    lib.sr_orc_byte_rle.argtypes = [vp, i64, i64, vp]
    lib.sr_orc_byte_rle.restype = i64
    lib.sr_orc_varints.argtypes = [vp, i64, i64, vp, vp]
    lib.sr_orc_varints.restype = i64
    lib.sr_orc_rle_v1.argtypes = [vp, i64, i32, i64, vp]
    lib.sr_orc_rle_v1.restype = i64
    lib.sr_delta_binary_packed.argtypes = [vp, i64, i64, vp]
    lib.sr_delta_binary_packed.restype = i64
    lib.sr_delta_byte_array.argtypes = [vp, vp, vp, i64, vp, i64, vp]
    lib.sr_delta_byte_array.restype = i64
    lib.sr_snappy_max_compressed.argtypes = [i64]
    lib.sr_snappy_max_compressed.restype = i64
    lib.sr_snappy_compress.argtypes = [vp, i64, vp, i64]
    lib.sr_snappy_compress.restype = i64
    lib.sr_rle_hybrid_encode.argtypes = [vp, i32, i64, i32, vp, i64]
    lib.sr_rle_hybrid_encode.restype = i64
    lib.sr_dict_encode_fixed.argtypes = [vp, i64, i32, vp, i64, i64, vp, vp,
                                         vp]
    lib.sr_dict_encode_fixed.restype = i64
    lib.sr_plain_byte_arrays.argtypes = [vp, vp, vp, i64, vp]
    lib.sr_plain_byte_arrays.restype = i64


def _sig_zstd_decode(lib):
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.sr_zstd_decompress.argtypes = [vp, i64, vp, i64]
    lib.sr_zstd_decompress.restype = i64


def _sig_lz4_decode(lib):
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.sr_lz4_block_decompress.argtypes = [vp, i64, vp, i64]
    lib.sr_lz4_block_decompress.restype = i64


def _sig_brotli_decode(lib):
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.sr_brotli_decompress.argtypes = [vp, i64, vp, i64]
    lib.sr_brotli_decompress.restype = i64


def _sig_lzo_decode(lib):
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.sr_lzo1x_decompress.argtypes = [vp, i64, vp, i64]
    lib.sr_lzo1x_decompress.restype = i64


_SIGNATURES = {"fused_filter_sum": _sig_fused_filter_sum,
               "hash_partition": _sig_hash_partition,
               "csv_parse": _sig_csv_parse,
               "file_formats": _sig_file_formats,
               "zstd_decode": _sig_zstd_decode,
               "lz4_decode": _sig_lz4_decode,
               "brotli_decode": _sig_brotli_decode,
               "lzo_decode": _sig_lzo_decode}


def _load(name: str = "fused_filter_sum"):
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _SIGNATURES[name](lib)
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


# --- CSV (csv_parse.cpp) ------------------------------------------------------

# column type tags shared with the C side: the reference's four, then the
# quoted lane's boolean and datetime
CSV_INT64, CSV_FLOAT64, CSV_DATE, CSV_STRING = 0, 1, 2, 3
CSV_BOOL, CSV_DATETIME = 4, 5
_NTHREADS = min(os.cpu_count() or 1, 8)


def _ptr(a) -> int:
    return a.ctypes.data


def _csv_buffers(types, n):
    bufs, masks = [], []
    for t in types:
        if t == CSV_STRING:
            bufs.append(np.empty(n * 2, dtype=np.int64))
        elif t == CSV_FLOAT64:
            bufs.append(np.empty(n, dtype=np.float64))
        else:
            bufs.append(np.empty(n, dtype=np.int64))
        masks.append(np.empty(n, dtype=np.uint8))
    ptrs = (ctypes.c_void_p * len(types))(*[_ptr(b) for b in bufs])
    mptrs = (ctypes.c_void_p * len(types))(*[_ptr(m) for m in masks])
    return bufs, masks, ptrs, mptrs


def parse_csv(data, types: list, delim: str = ",", quoted: bool = False):
    """Parse CSV bytes into typed numpy columns: (columns, valid masks,
    rows), or None when the file does not fit the lane (the caller tries
    the next lane or raises).

    `quoted=False` is the reference's lane (native/sr_native.cpp, copied:
    no quoting, an empty field is NULL); `quoted=True` the port's RFC 4180
    lane with pyarrow's NULL rules (csv_parse.cpp). A string column comes
    back as (buffer, offsets): the bytes the offsets index (the quoted lane
    unescapes in a copy) and (start, end) int64 pairs, one per row, for
    `dict_encode`."""
    lib = _load("csv_parse")
    buf = np.frombuffer(data, dtype=np.uint8)
    if quoted:
        buf = buf.copy()  # unescaped in place
    n = int(lib.sr_csv_count_rows(_ptr(buf), len(buf)))
    bufs, masks, ptrs, mptrs = _csv_buffers(types, n)
    tarr = np.asarray(types, dtype=np.int32)
    if quoted:
        err = np.zeros(1, dtype=np.int64)
        got = lib.sr_csv_parse_quoted(
            _ptr(buf), len(buf), delim.encode(), len(types), _ptr(tarr),
            ptrs, mptrs, n, _ptr(err))
    else:
        got = lib.sr_csv_parse(
            _ptr(buf), len(buf), delim.encode(), len(types), _ptr(tarr),
            ptrs, mptrs, n)
    if got < 0:
        return None
    cols = []
    for t, b in zip(types, bufs):
        if t == CSV_STRING:
            cols.append((buf, b[:2 * got].reshape(got, 2)))
        else:
            cols.append(b[:got])
    return cols, [m[:got].astype(bool) for m in masks], int(got)


def dict_encode(buf: np.ndarray, offs: np.ndarray):
    """(values, codes) of the strings buf[s:e] for each (s, e) row of
    `offs`: the sorted distinct strings as a numpy object array of str and
    int32 codes, equal to what StringDict.from_strings makes of the same
    strings (host C++: a hash table, then a parallel sort of the distinct
    strings by their bytes)."""
    lib = _load("csv_parse")
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    offs = np.ascontiguousarray(offs, dtype=np.int64).reshape(-1, 2)
    n = len(offs)
    codes = np.empty(n, dtype=np.int32)
    first = np.empty(max(n, 1), dtype=np.int64)
    k = int(lib.sr_dict_encode(_ptr(buf), _ptr(offs), n, _ptr(codes),
                               _ptr(first), _NTHREADS))
    return strings_at(buf, offs, first[:k]), codes


def strings_at(buf: np.ndarray, offs: np.ndarray, rows: np.ndarray,
               block: int = 1 << 20) -> np.ndarray:
    """The strings of `rows` as a numpy object array of str. ASCII blocks
    decode in bulk (a fixed-width bytes array cast to str); a block with
    other bytes decodes string by string (UTF-8, invalid bytes
    replaced)."""
    lib = _load("csv_parse")
    offs = np.ascontiguousarray(offs, dtype=np.int64).reshape(-1, 2)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    out = np.empty(len(rows), dtype=object)
    if not len(rows):
        return out
    lens = offs[rows, 1] - offs[rows, 0]
    for lo in range(0, len(rows), block):
        r = rows[lo:lo + block]
        w = max(int(lens[lo:lo + block].max()), 1)
        fixed = np.empty((len(r), w), dtype=np.uint8)
        lib.sr_gather_fixed(_ptr(buf), _ptr(offs), _ptr(r), len(r), w,
                            _ptr(fixed))
        if (fixed >= 0x80).any():
            out[lo:lo + len(r)] = [
                bytes(buf[s:e]).decode("utf-8", "replace")
                for s, e in offs[r]]
        else:
            out[lo:lo + len(r)] = fixed.view(f"S{w}").ravel().astype(
                f"U{w}").astype(object)
    return out


CSV_FMT_INT64, CSV_FMT_FLOAT64, CSV_FMT_DATE = 0, 1, 2
CSV_FMT_STRING, CSV_FMT_DECIMAL = 3, 6


def format_csv(columns: list, n: int, delim: str = ",",
               threads: int = _NTHREADS) -> bytes:
    """CSV text of `n` rows. Each column is (tag, data, valid, extra):
    int64 / float64 / date (int32 days) / string (int32 codes; extra is
    the dictionary as (bytes buffer, int64 offsets of k + 1)) / decimal
    (int64 scaled; extra is the scale). valid is a bool array or None.
    Row ranges format on `threads` threads (the C call releases the
    interpreter lock)."""
    import concurrent.futures as cf

    lib = _load("csv_parse")
    k = len(columns)
    keep = []  # arrays the pointers below point into

    def arr(a, dt):
        a = np.ascontiguousarray(a, dtype=dt)
        keep.append(a)
        return a

    tags = arr([c[0] for c in columns], np.int32)
    cols = (ctypes.c_void_p * k)()
    valid = (ctypes.c_void_p * k)()
    scales = arr([c[3] if c[0] == CSV_FMT_DECIMAL else 0 for c in columns],
                 np.int32)
    dbufs = (ctypes.c_void_p * k)()
    doffs = (ctypes.c_void_p * k)()
    width = 0
    for j, (tag, data, v, extra) in enumerate(columns):
        dt = {CSV_FMT_FLOAT64: np.float64, CSV_FMT_DATE: np.int32,
              CSV_FMT_STRING: np.int32}.get(tag, np.int64)
        cols[j] = _ptr(arr(data, dt))
        valid[j] = None if v is None else _ptr(arr(v, np.uint8))
        if tag == CSV_FMT_STRING:
            b, o = extra
            b = arr(np.frombuffer(b or b"\0", dtype=np.uint8), np.uint8)
            o = arr(o, np.int64)
            dbufs[j], doffs[j] = _ptr(b), _ptr(o)
            width += 2 * int(np.diff(o).max(initial=0)) + 3
        else:
            width += 26
    per_row = width + k + 1

    def part(lo, hi):
        cap = (hi - lo) * per_row + 64
        out = np.empty(cap, dtype=np.uint8)
        m = lib.sr_csv_format(k, _ptr(tags), cols, valid, _ptr(scales),
                              dbufs, doffs, lo, hi, delim.encode(),
                              _ptr(out), cap)
        if m < 0:
            raise RuntimeError("format_csv: output buffer too small")
        return out[:m].tobytes()

    step = max(-(-n // max(threads, 1)), 1)
    bounds = [(lo, min(n, lo + step)) for lo in range(0, n, step)]
    with cf.ThreadPoolExecutor(max(len(bounds), 1)) as ex:
        parts = list(ex.map(lambda b: part(*b), bounds))
    return b"".join(parts)


# --- parquet and ORC (file_formats.cpp) ---------------------------------------


def _check(consumed, what: str) -> int:
    if consumed < 0:
        raise ValueError(f"{what}: malformed or truncated input")
    return int(consumed)


def snappy_decompress(data, size: int) -> np.ndarray:
    """The raw snappy block `data`, decompressed to `size` bytes."""
    src = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(max(size, 1), dtype=np.uint8)
    m = _load("file_formats").sr_snappy_decompress(
        _ptr(src), len(src), _ptr(out), size)
    _check(m, "snappy")
    return out[:m]


def rle_bp_decode(data: np.ndarray, bit_width: int, count: int):
    """(values int32, bytes consumed) of parquet's RLE/bit-packed hybrid."""
    out = np.empty(max(count, 1), dtype=np.int32)
    used = _load("file_formats").sr_rle_bp_decode(
        _ptr(data), len(data), bit_width, count, _ptr(out))
    return out[:count], _check(used, "RLE/bit-packed hybrid")


def byte_array_offsets(data: np.ndarray, count: int, base: int = 0):
    """((start, end) int64 pairs of `count` PLAIN byte arrays, offset by
    `base`, and the bytes consumed)."""
    offs = np.empty((max(count, 1), 2), dtype=np.int64)
    used = _load("file_formats").sr_byte_array_offsets(
        _ptr(data), len(data), count, base, _ptr(offs))
    return offs[:count], _check(used, "PLAIN byte arrays")


def orc_rle_v2(data: np.ndarray, count: int, signed: bool) -> np.ndarray:
    """`count` int64 values of ORC integer RLE v2."""
    out = np.empty(max(count, 1), dtype=np.int64)
    _check(_load("file_formats").sr_orc_rle_v2(
        _ptr(data), len(data), int(signed), count, _ptr(out)),
        "ORC integer RLE v2")
    return out[:count]


def orc_rle_v1(data: np.ndarray, count: int, signed: bool) -> np.ndarray:
    """`count` int64 values of ORC integer RLE v1."""
    out = np.empty(max(count, 1), dtype=np.int64)
    _check(_load("file_formats").sr_orc_rle_v1(
        _ptr(data), len(data), int(signed), count, _ptr(out)),
        "ORC integer RLE v1")
    return out[:count]


def orc_varints(data: np.ndarray, count: int):
    """(high, low) int64 halves of `count` zigzag varints of up to 128
    bits (ORC DECIMAL values), two's complement."""
    hi = np.empty(max(count, 1), dtype=np.int64)
    lo = np.empty(max(count, 1), dtype=np.int64)
    _check(_load("file_formats").sr_orc_varints(
        _ptr(data), len(data), count, _ptr(hi), _ptr(lo)), "ORC varints")
    return hi[:count], lo[:count]


def delta_binary_packed(data: np.ndarray, count: int):
    """(the first `count` int64 values of parquet's DELTA_BINARY_PACKED,
    bytes consumed). INT32 columns take the low 32 bits."""
    out = np.empty(max(count, 1), dtype=np.int64)
    used = _load("file_formats").sr_delta_binary_packed(
        _ptr(data), len(data), count, _ptr(out))
    return out[:count], _check(used, "DELTA_BINARY_PACKED")


def delta_byte_array(data: np.ndarray, prefix: np.ndarray,
                     suffixes: np.ndarray):
    """(buffer, (start, end) offsets) of DELTA_BYTE_ARRAY values: value k
    is value k - 1's first prefix[k] bytes, then data[suffixes[k]]."""
    prefix = np.ascontiguousarray(prefix, dtype=np.int64)
    suffixes = np.ascontiguousarray(suffixes, dtype=np.int64).reshape(-1, 2)
    n = len(prefix)
    cap = int(prefix.sum() + (suffixes[:, 1] - suffixes[:, 0]).sum())
    out = np.empty(max(cap, 1), dtype=np.uint8)
    offs = np.empty((max(n, 1), 2), dtype=np.int64)
    _check(_load("file_formats").sr_delta_byte_array(
        _ptr(data), _ptr(prefix), _ptr(suffixes), n, _ptr(out), cap,
        _ptr(offs)), "DELTA_BYTE_ARRAY")
    return out[:cap], offs[:n]


def orc_byte_rle(data: np.ndarray, count: int) -> np.ndarray:
    """`count` bytes of ORC byte RLE."""
    out = np.empty(max(count, 1), dtype=np.uint8)
    _check(_load("file_formats").sr_orc_byte_rle(
        _ptr(data), len(data), count, _ptr(out)), "ORC byte RLE")
    return out[:count]


def snappy_compress(data) -> np.ndarray:
    """`data` (bytes or a uint8 array) as one raw snappy block, which
    `snappy_decompress` and every snappy reader take back. The C call
    releases the interpreter lock, so threads compress at once."""
    src = np.frombuffer(data, dtype=np.uint8)
    lib = _load("file_formats")
    out = np.empty(int(lib.sr_snappy_max_compressed(len(src))),
                   dtype=np.uint8)
    m = lib.sr_snappy_compress(_ptr(src) if len(src) else 0, len(src),
                               _ptr(out), len(out))
    if m < 0:
        raise RuntimeError("snappy_compress: the output buffer is too small")
    return out[:m]


def rle_hybrid_encode(values: np.ndarray, width: int) -> np.ndarray:
    """`values` (non-negative, below 2**width; uint8 or uint32, other
    integers are cast to uint32) in parquet's RLE/bit-packed hybrid at
    `width` bits, without a length prefix: repeated runs wherever a group
    of 8 starts 8 or more equal values, bit-packed runs between them."""
    v = np.asarray(values)
    if v.dtype != np.uint8:
        v = v.astype(np.uint32, copy=False)
    v = np.ascontiguousarray(v)
    n = len(v)
    cap = (n // 8 + 2) * (width + 10) + 16
    out = np.empty(cap, dtype=np.uint8)
    m = _load("file_formats").sr_rle_hybrid_encode(
        _ptr(v) if n else 0, v.itemsize, n, width, _ptr(out), cap)
    if m < 0:
        raise ValueError(f"rle_hybrid_encode: width {width} or buffer")
    return out[:m]


def dict_encode_fixed(values: np.ndarray, checks: np.ndarray,
                      max_entries: int):
    """(index uint32, firsts int64, encoded) of the rows of `values` (a
    [n, w] uint8 matrix, or a 1-D array of fixed-width items, compared by
    their bytes): the dictionary in order of first appearance, `firsts`
    the row of each entry's first appearance, `index` each of the first
    `encoded` rows' entry. At each of the sorted value counts `checks`, a
    dictionary of `max_entries` or more ends the encoding there."""
    v = np.ascontiguousarray(values)
    n = len(v)
    width = v.itemsize if v.ndim == 1 else v.shape[1] * v.itemsize
    checks = np.ascontiguousarray(checks, dtype=np.int64)
    index = np.empty(max(n, 1), dtype=np.uint32)
    firsts = np.empty(max(n, 1), dtype=np.int64)
    encoded = np.zeros(1, dtype=np.int64)
    nd = _load("file_formats").sr_dict_encode_fixed(
        _ptr(v) if n else 0, n, width,
        _ptr(checks) if len(checks) else 0, len(checks), int(max_entries),
        _ptr(index), _ptr(firsts), _ptr(encoded))
    if nd < 0:
        raise MemoryError("dict_encode_fixed: out of memory")
    k = int(encoded[0])
    return index[:k], firsts[:nd], k


def plain_byte_arrays(buf: np.ndarray, offs: np.ndarray,
                      rows: np.ndarray) -> np.ndarray:
    """PLAIN BYTE_ARRAY values: the strings buf[s:e] of the (s, e) rows
    `rows` of `offs`, each after its 4-byte little-endian length."""
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    offs = np.ascontiguousarray(offs, dtype=np.int64).reshape(-1, 2)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    size = int((offs[rows, 1] - offs[rows, 0]).sum()) + 4 * len(rows)
    out = np.empty(max(size, 1), dtype=np.uint8)
    m = _load("file_formats").sr_plain_byte_arrays(
        _ptr(buf if len(buf) else np.zeros(1, np.uint8)), _ptr(offs),
        _ptr(rows), len(rows), _ptr(out))
    return out[:m]


_ZSTD_ERRORS = {-1: "malformed or truncated input",
                -2: "content checksum mismatch",
                -3: "more output than the size given",
                -4: "the frame needs a dictionary"}


def zstd_decompress(data, size: int, exact: bool = True) -> np.ndarray:
    """Every Zstandard frame of `data` (skippable frames skipped), which
    must decompress to exactly `size` bytes (at most `size` when `exact` is
    false)."""
    src = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(max(size, 1), dtype=np.uint8)
    m = _load("zstd_decode").sr_zstd_decompress(
        _ptr(src), len(src), _ptr(out), size)
    if m < 0:
        raise ValueError(f"zstd: {_ZSTD_ERRORS.get(m, m)}")
    if exact and m != size:
        raise ValueError(f"zstd: {m} bytes where {size} were expected")
    return out[:m]


def lz4_decompress(data, size: int, exact: bool = True) -> np.ndarray:
    """One raw LZ4 block, decompressed to `size` bytes (at most `size`
    when `exact` is false)."""
    src = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(max(size, 1), dtype=np.uint8)
    m = _load("lz4_decode").sr_lz4_block_decompress(
        _ptr(src), len(src), _ptr(out), size)
    if m < 0 or (exact and m != size):
        raise ValueError("lz4: malformed or truncated block")
    return out[:m]


_LZO_ERRORS = {-1: "malformed instruction", -2: "input overrun",
               -3: "output past the size given",
               -4: "distance before the start of the output",
               -5: "missing end marker"}


def lzo_decompress(data, size: int, exact: bool = True) -> np.ndarray:
    """LZO1X blocks, one after another, as the ORC library decodes them,
    which must decompress to exactly `size` bytes (at most `size` when
    `exact` is false)."""
    src = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(max(size, 1), dtype=np.uint8)
    m = _load("lzo_decode").sr_lzo1x_decompress(
        _ptr(src) if len(src) else 0, len(src), _ptr(out), size)
    if m < 0:
        raise ValueError(f"lzo: {_LZO_ERRORS.get(m, m)}")
    if exact and m != size:
        raise ValueError(f"lzo: {m} bytes where {size} were expected")
    return out[:m]


def brotli_decompress(data, size: int) -> np.ndarray:
    """One Brotli stream (RFC 7932), which must decompress to exactly
    `size` bytes."""
    src = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(max(size, 1), dtype=np.uint8)
    m = _load("brotli_decode").sr_brotli_decompress(
        _ptr(src) if len(src) else 0, len(src), _ptr(out), size)
    if m == -3:
        raise ValueError("brotli: more output than the size given")
    if m < 0:
        raise ValueError("brotli: malformed or truncated stream")
    if m != size:
        raise ValueError(f"brotli: {m} bytes where {size} were expected")
    return out[:m]
