"""Write the static tables of RFC 7932 (Brotli) for the port's decoder.

    python tests/data/torch_formats/make_brotli_tables.py

Reads, through ctypes, what the installed `libbrotlicommon.so.1` exports
and writes `starrocks_tpu_torch/csrc/host/brotli_tables.inc`, which
`csrc/host/brotli_decode.cpp` includes (the port never loads libbrotli):

- the static dictionary (RFC 7932 section 8 and Appendix A; 122,784 bytes,
  SHA-256 in DICTIONARY_SHA256) and NDBITS, its size bits by word length;
- the 121 word transforms of Appendix B: each (prefix, type, suffix), the
  type as libbrotli numbers it (the comment below);
- the context lookup of section 7.1 as libbrotli lays it out: for each
  of the four context modes 512 bytes, p1's part then p2's, the context id
  being lut[p1] | lut[256 + p2].

`tables_of(path)` parses a written file back (the tests recompute the
hash from it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
OUT = os.path.join(ROOT, "starrocks_tpu_torch", "csrc", "host",
                   "brotli_tables.inc")
LIB = "libbrotlicommon.so.1"
DICTIONARY_SHA256 = ("20e42eb1b511c21806d4d227d07e5dd06877d8ce7b3a817f378f3"
                     "13653f35c70")
DICTIONARY_SIZE = 122784
NDBITS = (0, 0, 0, 0, 10, 10, 11, 11, 10, 10, 10, 10, 10, 9, 9, 8, 7, 7, 8,
          7, 7, 6, 6, 5, 5)
# transform types as libbrotli numbers them, and brotli_decode.cpp reads
# them: 0 identity, 1-9 omit the last n, 10 uppercase the first, 11
# uppercase all, 12-20 omit the first n - 11 (RFC 7932 Appendix B; its
# types 21-22 are not RFC 7932's and must not occur)


class _Dictionary(ctypes.Structure):
    _fields_ = [("size_bits_by_length", ctypes.c_uint8 * 32),
                ("offsets_by_length", ctypes.c_uint32 * 32),
                ("data_size", ctypes.c_size_t),
                ("data", ctypes.POINTER(ctypes.c_uint8))]


class _Transforms(ctypes.Structure):
    _fields_ = [("prefix_suffix_size", ctypes.c_uint16),
                ("prefix_suffix", ctypes.POINTER(ctypes.c_uint8)),
                ("prefix_suffix_map", ctypes.POINTER(ctypes.c_uint16)),
                ("num_transforms", ctypes.c_uint32),
                ("transforms", ctypes.POINTER(ctypes.c_uint8)),
                ("params", ctypes.POINTER(ctypes.c_uint8)),
                ("cut_off", ctypes.c_int16 * 10)]


def read_library():
    """(dictionary bytes, [(prefix, type, suffix)] x 121, 2048-byte
    context lookup) from libbrotlicommon."""
    lib = ctypes.CDLL(LIB)
    lib.BrotliGetDictionary.restype = ctypes.POINTER(_Dictionary)
    d = lib.BrotliGetDictionary().contents
    data = ctypes.string_at(d.data, d.data_size)
    assert d.data_size == DICTIONARY_SIZE
    assert hashlib.sha256(data).hexdigest() == DICTIONARY_SHA256
    assert tuple(d.size_bits_by_length[:25]) == NDBITS
    lib.BrotliGetTransforms.restype = ctypes.POINTER(_Transforms)
    t = lib.BrotliGetTransforms().contents
    assert t.num_transforms == 121 and not t.params
    blob = ctypes.string_at(t.prefix_suffix, t.prefix_suffix_size)
    raw = ctypes.string_at(t.transforms, 3 * t.num_transforms)

    def text(i):
        o = t.prefix_suffix_map[i]
        return blob[o + 1:o + 1 + blob[o]]

    triplets = [(text(raw[3 * k]), raw[3 * k + 1], text(raw[3 * k + 2]))
                for k in range(t.num_transforms)]
    assert all(0 <= ty <= 20 for _, ty, _ in triplets)
    lut = ctypes.c_uint8.in_dll(lib, "_kBrotliContextLookupTable")
    ctx = ctypes.string_at(ctypes.addressof(lut), 2048)
    return data, triplets, ctx


def _c_bytes(b: bytes, per_line: int = 16) -> str:
    return ",\n".join(
        "  " + ", ".join(f"0x{x:02x}" for x in b[i:i + per_line])
        for i in range(0, len(b), per_line))


def _c_string(b: bytes) -> str:
    return '"' + "".join(
        chr(x) if 0x20 <= x < 0x7f and chr(x) not in '"\\?' else f"\\{x:03o}"
        for x in b) + '"'


def render(data: bytes, triplets: list, ctx: bytes) -> str:
    lines = [
        "// The static tables of RFC 7932 (Brotli), generated by",
        "// tests/data/torch_formats/make_brotli_tables.py from "
        "libbrotlicommon 1.0.9;",
        "// included by brotli_decode.cpp. Do not edit.",
        f"// kDictionary: {DICTIONARY_SIZE} bytes, SHA-256 {DICTIONARY_SHA256}",
        "",
        "static const uint8_t kNdBits[25] = {"
        + ", ".join(map(str, NDBITS)) + "};",
        "",
        f"static const uint8_t kDictionary[{DICTIONARY_SIZE}] = {{",
        _c_bytes(data) + "};",
        "",
        "// {prefix, prefix length, type, suffix, suffix length}",
        "struct BrotliTransform {",
        "  const char* prefix;",
        "  uint8_t prefix_len;",
        "  uint8_t type;",
        "  const char* suffix;",
        "  uint8_t suffix_len;",
        "};",
        f"static const BrotliTransform kTransforms[{len(triplets)}] = {{",
    ]
    lines += [f"  {{{_c_string(p)}, {len(p)}, {ty}, {_c_string(s)}, "
              f"{len(s)}}}," for p, ty, s in triplets]
    lines += ["};", "", "static const uint8_t kContextLookup[2048] = {",
              _c_bytes(ctx) + "};", ""]
    return "\n".join(lines)


def tables_of(path: str = OUT):
    """(dictionary bytes, context lookup bytes, transform count) parsed
    back from a written file."""
    text = open(path).read()

    def array(name):
        body = re.search(name + r"\[\d+\] = \{(.*?)\};", text, re.S).group(1)
        return bytes(int(x, 16) for x in re.findall(r"0x[0-9a-f]{2}", body))

    ntr = int(re.search(r"kTransforms\[(\d+)\]", text).group(1))
    return array("kDictionary"), array("kContextLookup"), ntr


def main() -> int:
    data, triplets, ctx = read_library()
    with open(OUT, "w") as f:
        f.write(render(data, triplets, ctx))
    got, lut, ntr = tables_of(OUT)
    assert got == data and lut == ctx and ntr == 121
    print(f"{OUT}: {os.path.getsize(OUT)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
