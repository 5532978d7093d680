"""The port's LZO decoder (csrc/host/lzo_decode.cpp) and ORC LZO files.

No writer on hand writes ORC LZO, so tests/data/torch_formats/make_lzo.py
makes the blocks (its LZO1X compressor) and the files (`orc_to_lzo`, a
ZLIB file recompressed chunk by chunk). pyarrow's ORC reader, the ORC
library's LZO decoder, is the judge of both:

- every named input and hypothesis-drawn bytes round-trip through the
  compressor and `native.lzo_decompress`, the named ones also through
  pyarrow, and together they make the compressor emit every kind of
  instruction;
- hand-written blocks, one per instruction kind and the malformed ones,
  each the DATA stream of a one-row ORC BINARY file (whose DATA stream is
  the value's bytes): pyarrow and the port give the same value, or both
  refuse (pyarrow's OSError, the port's ValueError naming the file and
  LZO);
- a directory of ORC LZO files gives the reference's rows through both
  Sessions.

The rest lives beside the other codecs: the ORC variants with LZO in
test_torch_lake_formats.py, the SQL test over every type in
test_torch_external_tables.py, and the committed fixtures against their
manifest.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pyarrow as pa
import pyarrow.orc as po
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from starrocks_tpu.column.host_table import HostTable as JHostTable
from starrocks_tpu.runtime.session import Session as JSession
from starrocks_tpu_torch import native
from starrocks_tpu_torch.runtime.session import Session as TSession
from starrocks_tpu_torch.storage.external import _read_files

FORMATS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_formats")
sys.path.insert(0, FORMATS)
from make_lzo import lzo1x_compress, orc_to_lzo  # noqa: E402

BLOCK = 1 << 18  # the compression block size of the one-row files


def _random(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n).astype(
        np.uint8).tobytes()


def _far() -> bytes:
    """50 KiB of random bytes, then copies of its parts from 20,000 to
    49,151 bytes back: M4 matches on both sides of 32768, short and with
    the length extension."""
    out = bytearray(_random(51200, 3))
    for dist, length in ((20000, 6), (40000, 7), (30000, 300),
                         (49151, 200), (17000, 9)):
        at = len(out) - dist
        out += out[at:at + length] + _random(5, dist)
    return bytes(out)


def _near_and_far() -> bytes:
    """Random bytes with copies of 8 bytes from 1,000 back, each followed
    by 2 new bytes and a copy of 3 bytes from 2,500 back: M2 matches with
    short literal runs, then the M1 form that follows them."""
    out = bytearray(_random(4000, 6))
    for k in range(300):
        out += out[-1000:-992] + _random(2, 100 + k)
        out += out[-2500:-2497] + _random(4, 1000 + k)
    return bytes(out)


def _text() -> bytes:
    rng = np.random.default_rng(5)
    words = (b"the of and to in is for that with on as by this from at are "
             b"be or an was which have not it their more all").split()
    return b" ".join(words[i] for i in rng.integers(0, len(words), 20000))


INPUTS = {
    "empty": b"",
    "one": b"x",
    "two": b"xy",
    "three": b"xyz",
    "one_byte_x100000": b"a" * 100_000,
    "text": _text(),
    "random": _random(50_000, 1),
    "far_50k": _far(),
    "near_and_far": _near_and_far(),
    "small_alphabet": np.random.default_rng(2).integers(0, 4, 30_000).astype(
        np.uint8).tobytes(),
}

# every kind of instruction the compressor counts (make_lzo.py)
KINDS = {"first_literals", "short_literals", "literal_run",
         "literal_run_ext", "m1_near", "m1_far", "m2", "m3", "m3_ext", "m4",
         "m4_ext", "m4_far", "overlap", "overlap_1", "end"}


def _one_row_file(tmp_path, value: bytes, block: bytes | None) -> str:
    """A one-row ORC BINARY file holding `value`, compressed with LZO; its
    DATA stream is the one chunk `block` when given."""
    src = str(tmp_path / "src.orc")
    po.write_table(pa.table({"b": pa.array([value], pa.binary())}), src,
                   compression="zlib", compression_block_size=BLOCK,
                   row_index_stride=1 << 20)
    path = str(tmp_path / "lzo.orc")
    orc_to_lzo(src, path, data_block=block)
    return path


def _port_value(path: str) -> bytes:
    """The one value of a one-row BINARY file as the port reads it, after
    checking the read against the reference's from_arrow of pyarrow's."""
    got = _read_files([path])
    want = JHostTable.from_arrow(po.ORCFile(path).read())
    assert [(f.name, str(f.type)) for f in got.schema] == \
        [(f.name, str(f.type)) for f in want.schema]
    np.testing.assert_array_equal(got.arrays["b"], want.arrays["b"])
    return got.arrays["b"][0].view(np.uint8).tobytes()


@pytest.mark.parametrize("name", list(INPUTS))
def test_round_trip(tmp_path, name):
    """The compressor's block decodes to its input in the port and, as the
    DATA stream of a one-row file, in pyarrow."""
    data = INPUTS[name]
    z = lzo1x_compress(data)
    assert native.lzo_decompress(z, len(data)).tobytes() == data
    path = _one_row_file(tmp_path, data, z)
    assert po.ORCFile(path).read().column("b")[0].as_py() == data
    if data:  # (an empty value's BITMAP is 0 bits wide)
        assert _port_value(path) == data


def test_compressor_emits_every_instruction():
    stats: dict = {}
    for data in INPUTS.values():
        lzo1x_compress(data, stats)
    assert KINDS <= set(stats), KINDS - set(stats)


@settings(max_examples=60, deadline=None)
@given(st.binary(max_size=2000), st.integers(1, 40),
       st.binary(min_size=0, max_size=40))
def test_round_trip_hypothesis(data, repeat, tail):
    raw = data * repeat + tail
    z = lzo1x_compress(raw)
    assert native.lzo_decompress(z, len(raw)).tobytes() == raw
    assert native.lzo_decompress(z, len(raw) + 7,
                                 exact=False).tobytes() == raw


# --- hand-written blocks against the ORC library -----------------------------

def _lits(data: bytes) -> bytes:
    """A literal run after a match with no literals (state 0), or at the
    start: 0000LLLL, with the zero-byte extension past 18."""
    t = len(data)
    if t <= 18:
        return bytes([t - 3]) + data
    out = bytearray([0])
    t -= 18
    while t > 255:
        out.append(0)
        t -= 255
    return bytes(out + bytes([t])) + data


def _ext(length: int, bits: int, marker: int) -> bytes:
    top = (1 << bits) - 1
    if length <= top:
        return bytes([marker | length])
    out = bytearray([marker])
    length -= top
    while length > 255:
        out.append(0)
        length -= 255
    return bytes(out + bytes([length]))


def _m2(length: int, dist: int, s: int = 0) -> bytes:
    d = dist - 1
    return bytes([((length - 1) << 5) | ((d & 7) << 2) | s, d >> 3])


def _m3(length: int, dist: int, s: int = 0) -> bytes:
    e = ((dist - 1) << 2) | s
    return _ext(length - 2, 5, 0x20) + bytes([e & 0xFF, e >> 8])


def _m4(length: int, dist: int, s: int = 0) -> bytes:
    d = dist - 0x4000
    e = ((d & 0x3FFF) << 2) | s
    return _ext(length - 2, 3, 0x10 | ((d >> 11) & 8)) + bytes(
        [e & 0xFF, e >> 8])


def _copy(out: bytearray, dist: int, length: int):
    for _ in range(length):
        out.append(out[-dist])


END = b"\x11\x00\x00"


def _blocks() -> dict:
    """{name: (block, the bytes it decodes to, or None where the ORC
    library refuses it)}."""
    r = _random(60_000, 9)
    cases = {}

    cases["first_literals"] = (bytes([17 + 5]) + b"hello" + END, b"hello")
    cases["first_literals_238"] = (bytes([255]) + r[:238] + END, r[:238])
    # 1-3 literals in the low bits of a match
    out = bytearray(b"abcd")
    _copy(out, 4, 3)
    cases["short_literals"] = (bytes([21]) + b"abcd" + _m2(3, 4, 2) + b"XY"
                               + END, bytes(out) + b"XY")
    # a run of 4-18 after a match with none (state 0)
    out = bytearray(b"abcd")
    _copy(out, 4, 3)
    cases["literal_run"] = (bytes([21]) + b"abcd" + _m2(3, 4) + _lits(b"12345")
                            + END, bytes(out) + b"12345")
    cases["literal_run_ext"] = (_lits(r[:278]) + END, r[:278])
    cases["literal_run_ext_zeros"] = (_lits(r[:600]) + END, r[:600])
    # M1 after 4 or more literals: 2 bytes from within 1 KiB
    cases["m1_after_a_long_run"] = (bytes([21]) + b"abcd" + bytes([1 << 2, 0])
                                    + END, b"abcdcd")
    # M1 after 1-3 literals: 3 bytes from 2049-3072 back
    out = bytearray(r[:2100])
    _copy(out, 5, 3)
    out += b"XY"
    _copy(out, (3 << 2) + 1 + 2049, 3)
    out += b"Z"
    cases["m1_after_a_short_run"] = (
        _lits(r[:2100]) + _m2(3, 5, 2) + b"XY" + bytes([(1 << 2) | 1, 3])
        + b"Z" + END, bytes(out))
    out = bytearray(r[:40])
    _copy(out, 30, 10)
    cases["m3"] = (_lits(r[:40]) + _m3(10, 30) + END, bytes(out))
    out = bytearray(r[:40])
    _copy(out, 40, 100)
    cases["m3_ext"] = (_lits(r[:40]) + _m3(100, 40, 1) + b"q" + END,
                       bytes(out) + b"q")
    out = bytearray(r[:40])
    _copy(out, 37, 2 + 31 + 255 + 10)
    cases["m3_ext_zeros"] = (_lits(r[:40]) + _m3(298, 37) + END, bytes(out))
    out = bytearray(r[:16384])
    _copy(out, 16384, 20)
    cases["m3_at_16384"] = (_lits(r[:16384]) + _m3(20, 16384) + END,
                            bytes(out))
    out = bytearray(r[:20000])
    _copy(out, 18000, 5)
    cases["m4"] = (_lits(r[:20000]) + _m4(5, 18000) + END, bytes(out))
    out = bytearray(r[:40000])
    _copy(out, 40000, 6)
    cases["m4_past_32768"] = (_lits(r[:40000]) + _m4(6, 40000, 3) + b"abc"
                              + END, bytes(out) + b"abc")
    out = bytearray(r[:50000])
    _copy(out, 49151, 300)
    cases["m4_ext_at_49151"] = (_lits(r[:50000]) + _m4(300, 49151) + END,
                                bytes(out))
    out = bytearray(r[:16384])
    _copy(out, 16384, 4)
    cases["m4_at_16384"] = (_lits(r[:16384]) + _m4(4, 16384) + END,
                            bytes(out))
    cases["overlap_distance_1"] = (bytes([18]) + b"a" + _m3(50, 1) + END,
                                   b"a" * 51)
    out = bytearray(b"abc")
    _copy(out, 3, 8)
    cases["overlap"] = (bytes([20]) + b"abc" + _m2(8, 3) + END, bytes(out))
    cases["empty"] = (END, b"")
    cases["end_marker_tail_skipped"] = (bytes([20]) + b"abc" + b"\x11\x05\x07",
                                        b"abc")
    # after an end marker, another block; its match reaches into the first
    cases["two_blocks"] = (bytes([20]) + b"abc" + END + bytes([19]) + b"de"
                           + _m2(3, 5) + END, b"abcdeabc")
    # the malformed: both refuse
    cases["truncated_literals"] = (bytes([21]) + b"ab", None)
    cases["truncated_trailer"] = (_lits(r[:40]) + _m3(10, 30)[:2], None)
    cases["distance_before_start"] = (bytes([20]) + b"abc" + _m2(3, 5) + END,
                                      None)
    cases["m1_far_before_start"] = (bytes([20]) + b"abc" + bytes([0, 0])
                                    + END, None)
    cases["past_the_block_size"] = (bytes([18]) + b"a" + _m3(BLOCK, 1) + END,
                                    None)
    cases["no_end_marker"] = (bytes([22]) + b"hello", None)
    cases["first_byte_16"] = (bytes([16, 0, 0]) + END, None)
    return cases


BLOCKS = _blocks()


@pytest.mark.parametrize("name", list(BLOCKS))
def test_decoder_agrees_with_the_orc_library(tmp_path, name):
    """Each block as the DATA stream of a one-row BINARY file: pyarrow and
    the port read the same value (the one written by hand), or both
    refuse it."""
    block, want = BLOCKS[name]
    value = want if want is not None else b"v" * 5
    path = _one_row_file(tmp_path, value, block)
    if want is None:
        with pytest.raises(OSError):
            po.ORCFile(path).read()
        with pytest.raises(ValueError, match=r"lzo\.orc.*LZO"):
            _read_files([path])
        with pytest.raises(ValueError, match="lzo: "):
            native.lzo_decompress(block, BLOCK, exact=False)
        return
    assert po.ORCFile(path).read().column("b")[0].as_py() == want
    assert native.lzo_decompress(block, len(want)).tobytes() == want
    if want:
        assert _port_value(path) == want


def test_sessions_agree_on_an_lzo_directory(tmp_path):
    """CREATE EXTERNAL TABLE over two ORC LZO files: the same rows in both
    packages, through SQL (the reference reads them with pyarrow)."""
    rng = np.random.default_rng(4)
    n = 4000
    table = pa.table({
        "k": pa.array(np.arange(n), pa.int64()),
        "s": pa.array([f"s{v}" for v in rng.integers(0, 50, n)]),
        "x": pa.array([None if i % 9 == 0 else float(v) for i, v in
                       enumerate(rng.normal(size=n))], pa.float64()),
    })
    d = tmp_path / "lake"
    d.mkdir()
    for i, part in enumerate((table.slice(0, 1500), table.slice(1500))):
        src = str(tmp_path / f"zlib{i}.orc")
        po.write_table(part, src, compression="zlib",
                       row_index_stride=1 << 20)
        orc_to_lzo(src, str(d / f"part-{i}.orc"))
    out = []
    for s in (TSession(device="cpu"), JSession()):
        s.sql(f"create external table lake from '{d}'")
        out.append(s.sql("select s, count(*), sum(x), max(k) from lake "
                         "group by s order by s").rows())
        out.append(s.sql("select * from lake order by k").rows())
    assert out[:2] == out[2:] and len(out[1]) == n
