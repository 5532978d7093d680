"""Write the lake fixtures of the port's `lake` path and their manifest.

    JAX_PLATFORMS=cpu python tests/data/torch_formats/make_fixtures.py

Needs pyarrow (to write the files) and the JAX package (its
`HostTable.from_arrow` gives the values each manifest entry holds); the
port reads the files back without either. The data is the port's
`gen_tpch(0.1, 42)` `orders` (150,000 rows, every column) for the two
files the lake path copies 100 times (parquet and ORC, both ZSTD), and
`gen_tpch(0.01, 42)` `orders` (15,000 rows) or its first 3,000 for one
file of each other variant: parquet BROTLI (`orders` SF 0.1 at pyarrow's
default level, and 1,000 English-like sentences at level 11), LZ4_RAW,
the four DELTA and BYTE_STREAM_SPLIT encodings with v2 pages, INT96,
binary and LIST columns with NULLs; ORC LZ4, ORC file version 0.11, ORC
TIMESTAMP/BINARY/LIST; ORC LZO (`orders` SF 0.1 in 3 stripes, which the
lake path copies 10 times, and the TIMESTAMP/BINARY/LIST table), which no
writer on hand writes: pyarrow writes ZLIB and make_lzo.py's `orc_to_lzo`
recompresses every chunk with its own LZO1X compressor; and a directory
of two parquet files that differ in their columns (written before and
after an ADD COLUMN).

MANIFEST.json holds, for each fixture, its rows and for each column (as
the reference's `from_arrow` of pyarrow's read, merged as the reference
merges a directory) its type, its NULL count and
`starrocks_tpu_torch.storage.formats.column_digest` of its values.
"""

from __future__ import annotations

import decimal
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402
import pyarrow.orc as po  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402

from make_lzo import orc_to_lzo  # noqa: E402

SEED = 42
SMALL = 3000  # rows of the type variants


def arrow_orders(sf: float) -> pa.Table:
    """The port's generated `orders` as a pyarrow table of the same types
    (DECIMAL(15,2) as decimal128, DATE as date32, strings as strings)."""
    from starrocks_tpu_torch.storage.datagen.tpch import gen_tpch

    ht = gen_tpch(sf, SEED)["orders"]
    cols = {}
    for f in ht.schema:
        a = ht.arrays[f.name]
        t = str(f.type)
        if f.dict is not None:
            cols[f.name] = pa.array(f.dict.values[a].tolist(), pa.string())
        elif t.startswith("DECIMAL"):
            cols[f.name] = pa.array(
                [decimal.Decimal(int(v)).scaleb(-f.type.scale) for v in a],
                pa.decimal128(f.type.precision, f.type.scale))
        elif t == "DATE":
            cols[f.name] = pa.array(a.astype(np.int32)).cast(pa.date32())
        elif t == "INT":
            cols[f.name] = pa.array(a.astype(np.int32), pa.int32())
        else:
            cols[f.name] = pa.array(a.astype(np.int64), pa.int64())
    return pa.table(cols)


def _nulls(arr: pa.Array, every: int) -> pa.Array:
    mask = np.arange(len(arr)) % every == every - 1
    return pa.array(arr.to_pylist(), arr.type, mask=mask)


def encoded(o: pa.Table) -> pa.Table:
    """Columns for the DELTA and BYTE_STREAM_SPLIT encodings, NULLs in
    some."""
    return pa.table({
        "o_orderkey": o.column("o_orderkey"),
        "o_custkey": _nulls(o.column("o_custkey").combine_chunks(), 13),
        "o_shippriority": o.column("o_shippriority"),
        "o_orderdate": o.column("o_orderdate"),
        "o_totalprice": o.column("o_totalprice"),
        "o_price": _nulls(pa.array(
            o.column("o_totalprice").cast(pa.float64()).to_numpy()), 7),
        "o_orderpriority": _nulls(
            o.column("o_orderpriority").combine_chunks(), 11),
        "o_clerk": o.column("o_clerk"),
        "o_orderstatus": o.column("o_orderstatus"),
    })


ENCODINGS = {"o_orderkey": "DELTA_BINARY_PACKED",
             "o_custkey": "DELTA_BINARY_PACKED",
             "o_shippriority": "DELTA_BINARY_PACKED",
             "o_orderdate": "BYTE_STREAM_SPLIT",
             "o_totalprice": "BYTE_STREAM_SPLIT",
             "o_price": "BYTE_STREAM_SPLIT",
             "o_orderpriority": "DELTA_LENGTH_BYTE_ARRAY",
             "o_clerk": "DELTA_BYTE_ARRAY",
             "o_orderstatus": "DELTA_BYTE_ARRAY"}


def typed(o: pa.Table, int96: bool) -> pa.Table:
    """Timestamps, binaries and lists derived from `orders`, NULLs in
    each: a timestamp of the order day plus a time of day, the key as 8
    big-endian bytes (binary) and 4 fixed bytes (parquet only), the line
    numbers and two tags of each order as lists (NULL lists and empty
    ones)."""
    keys = o.column("o_orderkey").to_numpy()
    days = o.column("o_orderdate").cast(pa.int32()).to_numpy()
    n = len(keys)
    us = (days.astype(np.int64) * 86_400_000_000
          + (keys * 7_919_000_003) % 86_400_000_000)
    every = np.arange(n)
    cols = {
        "o_orderkey": pa.array(keys, pa.int64()),
        "o_ts": pa.array(us, pa.timestamp("us"), mask=every % 7 == 3),
        "o_key_bytes": pa.array([int(k).to_bytes(8, "big") for k in keys],
                                pa.binary(), mask=every % 5 == 1),
    }
    if int96:
        cols["o_flba"] = pa.array([int(k % 2**32).to_bytes(4, "little")
                                   for k in keys], pa.binary(4),
                                  mask=every % 6 == 2)
    clerk = o.column("o_clerk").to_pylist()
    prio = o.column("o_orderpriority").to_pylist()
    cols["o_lines"] = pa.array(
        [None if i % 11 == 4 else [int(k) * 10 + j for j in range(k % 5)]
         for i, k in enumerate(keys)], pa.list_(pa.int64()))
    cols["o_tags"] = pa.array(
        [None if i % 9 == 5 else ([] if k % 4 == 0 else [clerk[i], prio[i]])
         for i, k in enumerate(keys)], pa.list_(pa.string()))
    return pa.table(cols)


# common English words (the kind Brotli's static dictionary holds)
VOCAB = ("the of and to in is for that with on as by this from at are be "
         "or an was which have not it their more all has but one also can "
         "other new when after would about these first been who only will "
         "into such time people there some many most during may between "
         "where over through world were than well under system use used "
         "while both each could since number part state national company "
         "information available university development public "
         "international government history service including however "
         "located known several following within group music family city "
         "population school water country season league children program "
         "important research language example business president "
         "character original political special general release building "
         "community published different description management question "
         "according experience performance security technology "
         "environment understand application particular").split()


def text(n: int) -> pa.Table:
    """n English-like sentences of 6-14 words from VOCAB (seeded), and
    each in title case and in capitals, NULLs in some: written in small
    pages, each its own Brotli stream, level 11 codes many words as
    static dictionary references through the word transforms."""
    rng = np.random.default_rng(SEED)
    lines = []
    for _ in range(n):
        words = [VOCAB[i] for i in rng.integers(0, len(VOCAB),
                                                int(rng.integers(6, 15)))]
        s = " ".join(words)
        lines.append(s[0].upper() + s[1:] + ".")
    return pa.table({
        "line": pa.array(lines, pa.string()),
        "title": _nulls(pa.array([x.title() for x in lines], pa.string()),
                        17),
        "upper": pa.array([x.upper() for x in lines], pa.string()),
    })


def evolved(o: pa.Table):
    """Two parts of `orders`: the first before an ADD COLUMN
    (o_orderpriority), the second after it."""
    cols = ["o_orderkey", "o_totalprice", "o_orderdate"]
    old = o.slice(0, 2000).select(cols)
    new = o.slice(2000, 2000).select(cols + ["o_orderpriority"])
    return old, new


def manifest_entry(what: str, fmt: str, table: pa.Table) -> dict:
    from starrocks_tpu.column.host_table import HostTable
    from starrocks_tpu_torch.storage.formats import column_digest

    ht = HostTable.from_arrow(table)
    cols = []
    for f in ht.schema:
        v = ht.valids.get(f.name)
        cols.append({"name": f.name, "type": str(f.type),
                     "nulls": 0 if v is None else int((~v).sum()),
                     "digest": column_digest(f, ht.arrays[f.name], v)})
    return {"what": what, "format": fmt, "rows": ht.num_rows,
            "columns": cols}


def main() -> int:
    big = arrow_orders(0.1)
    small = arrow_orders(0.01)
    part = small.slice(0, SMALL)
    man = {}

    def parquet(name, table, what, **kw):
        path = os.path.join(HERE, name)
        pq.write_table(table, path, **kw)
        man[name] = manifest_entry(what, "parquet", pq.read_table(path))

    def orc(name, table, what, **kw):
        path = os.path.join(HERE, name)
        po.write_table(table, path, **kw)
        man[name] = manifest_entry(what, "orc", po.ORCFile(path).read())

    def orc_lzo(name, table, what, **kw):
        """Written as ZLIB with one row group per stripe (its row-index
        positions stay true), then recompressed with LZO."""
        path = os.path.join(HERE, name)
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(tmp, "zlib.orc")
            po.write_table(table, src, compression="zlib",
                           row_index_stride=1 << 20, **kw)
            orc_to_lzo(src, path)
        man[name] = manifest_entry(what, "orc", po.ORCFile(path).read())

    parquet("orders_zstd.parquet", big, "lake: orders SF 0.1, ZSTD",
            compression="zstd")
    orc("orders_zstd.orc", big, "lake: orders SF 0.1, ZSTD",
        compression="zstd")
    parquet("orders_brotli.parquet", big, "lake: orders SF 0.1, BROTLI "
            "(pyarrow's default level)", compression="brotli")
    parquet("text_brotli11.parquet", text(1000),
            "BROTLI level 11 over English-like text in 2 KB pages (static "
            "dictionary references, word transforms), PLAIN strings",
            compression="brotli", compression_level=11,
            use_dictionary=False, data_page_size=2048, write_batch_size=32)
    parquet("orders_lz4raw.parquet", small, "LZ4_RAW (compression='lz4')",
            compression="lz4")
    parquet("encodings_v2.parquet", encoded(small),
            "DELTA_BINARY_PACKED, DELTA_LENGTH_BYTE_ARRAY, DELTA_BYTE_ARRAY "
            "and BYTE_STREAM_SPLIT, v2 pages, NULLs",
            use_dictionary=False, column_encoding=ENCODINGS,
            data_page_version="2.0", compression="zstd",
            data_page_size=16384)
    parquet("int96_binary_list.parquet", typed(part, True),
            "INT96, binary, fixed-length binary and LIST columns, NULLs",
            use_deprecated_int96_timestamps=True)
    orc("orders_lz4.orc", small, "ORC LZ4", compression="lz4")
    orc("orders_v011.orc", small, "ORC file version 0.11 (RLE v1), "
        "strings DICTIONARY", file_version="0.11",
        dictionary_key_size_threshold=1.0, compression="zlib")
    orc("ts_binary_list.orc", typed(part, False),
        "ORC TIMESTAMP, BINARY and LIST columns, NULLs", compression="zstd")
    orc_lzo("orders_lzo.orc", big, "lake: orders SF 0.1, ORC LZO (3 "
            "stripes, 64 KiB blocks)", compression_block_size=65536,
            stripe_size=1 << 19)
    orc_lzo("ts_binary_list_lzo.orc", typed(part, False),
            "ORC LZO: TIMESTAMP, BINARY and LIST columns, NULLs")
    d = os.path.join(HERE, "evolved")
    os.makedirs(d, exist_ok=True)
    old, new = evolved(small)
    pq.write_table(old, os.path.join(d, "part-0.parquet"))
    pq.write_table(new, os.path.join(d, "part-1.parquet"))
    merged = pa.concat_tables(
        [pq.read_table(os.path.join(d, f"part-{i}.parquet"))
         for i in range(2)], promote_options="default")
    man["evolved"] = manifest_entry(
        "two files that differ in their columns (ADD COLUMN between them)",
        "parquet", merged)
    with open(os.path.join(HERE, "MANIFEST.json"), "w") as fh:
        json.dump({"seed": SEED, "fixtures": man}, fh, indent=1)
        fh.write("\n")
    total = sum(os.path.getsize(os.path.join(r, f))
                for r, _, fs in os.walk(HERE) for f in fs)
    print(f"{len(man)} fixtures, {total / 1e6:.2f} MB under {HERE}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
