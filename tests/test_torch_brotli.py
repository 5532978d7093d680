"""The port's Brotli decoder (csrc/host/brotli_decode.cpp, RFC 7932) and
parquet BROTLI files.

The decoder against pyarrow's encoder (`pa.Codec('brotli', q)`) at every
level 0-11 on English-like text (static dictionary references and word
transforms), random bytes (level 0 stores them in uncompressed
meta-blocks), long runs and the empty input, and on hypothesis-drawn
inputs; corrupt and truncated streams raise ValueError, and in a parquet
file the error names the file. The committed tables (brotli_tables.inc)
hash to RFC 7932's dictionary and equal what
tests/data/torch_formats/make_brotli_tables.py reads from libbrotlicommon
where that library is present. A BROTLI external table gives the
reference's rows through both Sessions. (The committed BROTLI fixtures are
held to their manifests by test_torch_lake_formats.py.) Parquet LZO
still raises a named NotImplementedError (pyarrow, and so the reference,
refuses it too); ORC LZO reads since the port has its decoder
(tests/test_torch_lzo.py), and a ZLIB file labelled LZO is refused by
both readers.
"""

from __future__ import annotations

import hashlib
import os
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from starrocks_tpu.runtime.session import Session as JSession
from starrocks_tpu_torch import native
from starrocks_tpu_torch.runtime.session import Session as TSession
from starrocks_tpu_torch.storage.external import _read_files

FORMATS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_formats")
sys.path.insert(0, FORMATS)
import make_brotli_tables as tables  # noqa: E402


def _english(n: int = 600) -> bytes:
    """n English-like sentences (make_fixtures.VOCAB), some capitalized,
    some in capitals."""
    from make_fixtures import VOCAB

    rng = np.random.default_rng(11)
    out = []
    for i in range(n):
        s = " ".join(VOCAB[j] for j in rng.integers(0, len(VOCAB), 9))
        out.append(s.title() if i % 5 == 1 else
                   s.upper() if i % 7 == 2 else s)
    return (". ".join(out) + ".").encode()


def _inputs() -> dict:
    rng = np.random.default_rng(3)
    return {
        "english": _english(),
        "random": rng.integers(0, 256, 40_000, dtype=np.uint8).tobytes(),
        "runs": b"a" * 70_000 + b"b" * 90_000 + b"ab" * 20_000 + b"c",
        "empty": b"",
    }


INPUTS = _inputs()


@pytest.mark.parametrize("level", range(12))
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_brotli_equals_pyarrow(name, level):
    data = INPUTS[name]
    comp = pa.Codec("brotli", compression_level=level).compress(
        data, asbytes=True)
    assert native.brotli_decompress(comp, len(data)).tobytes() == data


@settings(max_examples=40, deadline=None)
@given(st.binary(min_size=0, max_size=3000), st.integers(1, 40),
       st.integers(0, 11))
def test_brotli_round_trip_hypothesis(data, repeat, level):
    data = data * repeat
    comp = pa.Codec("brotli", compression_level=level).compress(
        data, asbytes=True)
    assert native.brotli_decompress(comp, len(data)).tobytes() == data


def test_corrupt_and_truncated_streams_raise():
    data = INPUTS["english"]
    comp = pa.Codec("brotli", compression_level=11).compress(data,
                                                            asbytes=True)
    with pytest.raises(ValueError, match="brotli"):
        native.brotli_decompress(comp[:len(comp) // 2], len(data))
    with pytest.raises(ValueError, match="brotli"):
        native.brotli_decompress(comp, len(data) - 1)  # more than the size
    with pytest.raises(ValueError, match="brotli"):  # a large window
        native.brotli_decompress(b"\x11" + comp[1:], len(data))
    rng = np.random.default_rng(5)
    for _ in range(200):  # flipped bits: an error or some bytes, no crash
        b = bytearray(comp)
        b[int(rng.integers(0, len(b)))] ^= 1 << int(rng.integers(0, 8))
        try:
            native.brotli_decompress(bytes(b), len(data))
        except ValueError:
            pass


class _BitWriter:
    """LSB-first bits, as a Brotli stream holds them."""

    def __init__(self):
        self.value = 0
        self.n = 0

    def put(self, v: int, k: int) -> "_BitWriter":
        self.value |= v << self.n
        self.n += k
        return self

    def simple_code(self, symbol: int, alphabet_bits: int) -> "_BitWriter":
        # HSKIP 1 (a simple code), NSYM - 1 = 0, the one symbol
        return self.put(1, 2).put(0, 2).put(symbol, alphabet_bits)

    def tail_of_ones(self, nbits: int) -> bytes:
        """The bits so far, then nbits one-bits, then 8 zero bytes."""
        total = self.n + nbits
        head = self.value | (((1 << (-self.n % 8)) - 1) << self.n)
        nhead = (self.n + 7) // 8
        return (head.to_bytes(nhead, "little") +
                b"\xff" * ((total - 8 * nhead) // 8) +
                bytes([(1 << (total % 8)) - 1] if total % 8 else []) +
                bytes(8))


def _one_type_stream(too_many: str) -> tuple:
    """A meta-block whose categories have one block type each (block count
    2^24) that asks for one block more: 2^24 + 1 commands that each
    output nothing (word 984 of length 4 under transform 63, which omits
    all four bytes), or 2^24 + 22593 literals where MLEN is 2^24."""
    w = _BitWriter().put(0, 1)  # WBITS 16
    if too_many == "commands":
        mlen, nib = 1, 0
    else:
        mlen, nib = 1 << 24, 2
    w.put(1, 1).put(0, 1).put(nib, 2).put(mlen - 1, 4 * (nib + 4))
    w.put(0, 3)  # NBLTYPESL, NBLTYPESI, NBLTYPESD: one type each
    w.put(3, 2).put(0, 4)  # NPOSTFIX 3, NDIRECT 0
    w.put(0, 2).put(0, 1).put(0, 1)  # context mode, NTREESL, NTREESD
    w.simple_code(ord("a"), 8)
    if too_many == "commands":
        # cell 2: insert 0, copy 4, an explicit distance; distance code
        # 184 has 11 extra bits, all ones: 65497, past the output
        w.simple_code(130, 10).simple_code(184, 9)
        return w.tail_of_ones(11 * ((1 << 24) + 1)), mlen
    # cell 7: insert code 23 (22594 + 24 extra bits), copy 2
    w.simple_code(504, 10).simple_code(0, 9)
    return w.put((1 << 24) - 1, 24).tail_of_ones(0), mlen


@pytest.mark.parametrize("too_many", ["commands", "literals"])
def test_one_block_type_past_its_count_raises(too_many):
    stream, mlen = _one_type_stream(too_many)
    with pytest.raises(ValueError, match="brotli: malformed"):
        native.brotli_decompress(stream, mlen)


def test_corrupt_page_names_the_file(tmp_path):
    path = tmp_path / "c.parquet"
    pq.write_table(pa.table({"s": [f"value {i}" for i in range(5000)]}),
                   str(path), compression="brotli", use_dictionary=False)
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 3] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="c.parquet"):
        _read_files([str(path)])


def test_committed_tables_hash_to_the_rfc_dictionary():
    data, lut, ntransforms = tables.tables_of(tables.OUT)
    assert len(data) == tables.DICTIONARY_SIZE == 122784
    assert hashlib.sha256(data).hexdigest() == tables.DICTIONARY_SHA256
    assert tables.DICTIONARY_SHA256 in open(tables.OUT).read()
    assert data[:20] == b"timedownlifeleftback"
    assert ntransforms == 121 and len(lut) == 2048
    # the NDBITS table: word counts fill the dictionary exactly
    assert sum(n << b for n, b in enumerate(tables.NDBITS)
               if n >= 4) == len(data)
    try:
        want = tables.read_library()
    except OSError:  # no libbrotlicommon here: the committed file stands
        return
    assert (data, lut) == (want[0], want[2])
    assert tables.render(*want) == open(tables.OUT).read()


@pytest.mark.parametrize("level", [None, 11])
def test_brotli_external_table_through_both_sessions(tmp_path, level):
    """A directory of two BROTLI parquet files (strings with NULLs, dates,
    doubles) as an external table: both packages give the same rows."""
    rng = np.random.default_rng(9)
    n = 4000
    words = _english(200).decode().split()
    table = pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "s": pa.array([" ".join(words[i % 150:i % 150 + 4])
                       for i in range(n)], pa.string(),
                      mask=np.arange(n) % 13 == 0),
        "d": pa.array(rng.integers(0, 20000, n).astype(np.int32),
                      pa.int32()).cast(pa.date32()),
        "x": pa.array(rng.normal(size=n)),
    })
    d = tmp_path / "lake"
    d.mkdir()
    for i, part in enumerate((table.slice(0, 1500), table.slice(1500))):
        kw = {} if level is None else {"compression_level": level}
        pq.write_table(part, str(d / f"p{i}.parquet"), compression="brotli",
                       **kw)
    out = []
    for s in (TSession(device="cpu"), JSession()):
        s.sql(f"create external table lake from '{d}'")
        out.append(s.sql("select * from lake order by k").rows())
    assert out[0] == out[1] and len(out[0]) == n


def _patched(path, old: bytes, new: bytes, tail: int):
    """Replace the one `old` in the last `tail` bytes of the file."""
    raw = bytearray(path.read_bytes())
    at = raw.rfind(old, len(raw) - tail)
    assert at >= 0 and raw.count(old, len(raw) - tail) == 1
    raw[at:at + len(old)] = new
    path.write_bytes(bytes(raw))


def test_lzo_raises_a_named_error(tmp_path):
    """A parquet column chunk and an ORC file that say LZO (codec 3;
    pyarrow writes neither, so the codec field is patched). Parquet: the
    port raises a NotImplementedError naming LZO and the file, and pyarrow
    refuses the file too. ORC, whose LZO the port reads: the chunks are
    ZLIB's, so the port's LZO decoder refuses them with a ValueError
    naming LZO and the file, and pyarrow (the ORC library's LZO decoder)
    with an OSError."""
    import pyarrow.orc as po

    p = tmp_path / "lzo.parquet"
    pq.write_table(pa.table({"a": list(range(100))}), str(p),
                   compression="none")
    # ColumnMetaData: codec (field 4, i32 0) before num_values (field 5)
    _patched(p, b"\x15\x00\x16", b"\x15\x06\x16", 1000)
    with pytest.raises(NotImplementedError,
                       match="lzo.parquet.*LZO|LZO.*lzo.parquet"):
        _read_files([str(p)])
    with pytest.raises(Exception):  # the reference's reader refuses it too
        pq.read_table(str(p))
    o = tmp_path / "lzo.orc"
    po.write_table(pa.table({"a": list(range(100))}), str(o),
                   compression="zlib")
    # the PostScript's compression kind (field 2): ZLIB 1 -> LZO 3
    _patched(o, b"\x10\x01", b"\x10\x03", 24)
    with pytest.raises(ValueError, match="lzo.orc.*LZO|LZO.*lzo.orc"):
        _read_files([str(o)])
    with pytest.raises(OSError):
        po.ORCFile(str(o)).read()
