"""LZO1X blocks and ORC files compressed with LZO, for the fixtures and
tests of the port's LZO decoder (starrocks_tpu_torch/csrc/host/
lzo_decode.cpp). No writer on hand writes ORC LZO, so this module makes
the files itself:

- `lzo1x_compress(data)`: a greedy hash-chain LZO1X-1 compressor, written
  from the format's public description (the Linux kernel's
  Documentation/staging/lzo.rst). It emits every instruction a decoder
  has to handle: a first byte above 17, literal runs of 1-3 bytes in the
  low bits of the previous match, runs of 4 or more with the zero-byte
  length extension, M1 matches after a short run and after a long one,
  M2, M3 and M4 (past 16 KiB, up to 49151) with the zero-byte length
  extension, copies that overlap themselves, and the end marker
  `11 00 00`. `stats`, when given, counts what it emitted by kind.
  It writes for the ORC library's decoder (the one pyarrow reads with),
  which departs from lzo.rst in two places. Its two M1 forms are the
  other way round: after 1-3 literals an M1 copies 3 bytes from
  2049-3072 back, after 4 or more it copies 2 bytes from within 1 KiB.
  And it takes the byte 0x11 for the end marker whatever follows it, so
  an M4 match of 3 bytes at 16385-32768 (which opens with 0x11) is never
  written: M4 matches are 4 bytes or longer.
- `orc_to_lzo(src, dst)`: a file `pyarrow.orc.write_table` wrote with
  `compression="zlib"` rewritten as ORC LZO (PostScript compression kind
  3): every compressed region (each stream, each stripe footer, the
  metadata and the footer) inflated and cut again into chunks of the
  file's block size, each chunk one LZO1X block under ORC's 3-byte chunk
  header (stored with the "original" bit when it does not shrink), and
  the lengths and offsets that name them rewritten. Row-index positions
  name compressed offsets, so the source must have one row group per
  stripe (`row_index_stride` at least the stripe's rows), whose
  positions are all 0 and stay true; the rewriter refuses another file.
  `data_block` puts one given block in the DATA stream of column 1 (the
  decoder tests: a one-column BINARY file's DATA stream is the value's
  bytes). The output is read back with pyarrow and must equal the
  source's read (unless `data_block` is given).

Runs where pyarrow is installed (the tests and make_fixtures.py); the
port reads the files without it.
"""

from __future__ import annotations

import zlib

M2_MAX_OFFSET = 2048
M3_MAX_OFFSET = 16384
M4_MAX_OFFSET = 49151
CHAIN = 16  # candidates tried per position, newest first
KEEP = 32  # positions kept per 3-byte key


def _common(data: bytes, a: int, b: int, limit: int) -> int:
    """The length of the common prefix of data[a:] and data[b:], at most
    `limit` (a > b; the two may overlap)."""
    n, step = 0, 8
    while n + step <= limit and data[a + n:a + n + step] == \
            data[b + n:b + n + step]:
        n += step
        step = min(step * 2, 4096)
    while n < limit and data[a + n] == data[b + n]:
        n += 1
    return n


def _count(stats, kind: str):
    if stats is not None:
        stats[kind] = stats.get(kind, 0) + 1


def lzo1x_compress(data: bytes, stats: dict | None = None) -> bytes:
    """One LZO1X block of `data`, ending with the end marker."""
    data = bytes(data)
    n = len(data)
    out = bytearray()
    heads: dict = {}  # 3-byte key -> its last KEEP positions
    pairs: dict = {}  # 2-byte key -> its last position
    state = 0  # literals the last instruction copied (4: four or more)

    def literals(lo: int, hi: int):
        nonlocal state
        t = hi - lo
        if t == 0:
            state = 0
            return
        if not out and t <= 238:
            out.append(17 + t)
            _count(stats, "first_literals")
        elif t <= 3:
            out[-2] |= t  # the low bits of the previous match
            _count(stats, "short_literals")
        elif t <= 18:
            out.append(t - 3)
            _count(stats, "literal_run")
        else:
            out.append(0)
            tt = t - 18
            while tt > 255:
                out.append(0)
                tt -= 255
            out.append(tt)
            _count(stats, "literal_run_ext")
        out.extend(data[lo:hi])
        state = t if t <= 3 else 4

    def extended(length: int, bits: int, marker: int):
        """A match command whose length field has `bits` bits."""
        top = (1 << bits) - 1
        if length <= top:
            out.append(marker | length)
            return False
        out.append(marker)
        length -= top
        while length > 255:
            out.append(0)
            length -= 255
        out.append(length)
        return True

    def match(d: int, m: int):
        if m == 2:  # after 4 or more literals
            dd = d - 1
            out.extend((((dd & 3) << 2), dd >> 2))
            _count(stats, "m1_near")
        elif m == 3 and 1 <= state <= 3 and M2_MAX_OFFSET < d <= 3072:
            dd = d - 1 - M2_MAX_OFFSET
            out.extend((((dd & 3) << 2), dd >> 2))
            _count(stats, "m1_far")
        elif m <= 8 and d <= M2_MAX_OFFSET:
            dd = d - 1
            out.extend((((m - 1) << 5) | ((dd & 7) << 2), dd >> 3))
            _count(stats, "m2")
        elif d <= M3_MAX_OFFSET:
            dd = d - 1
            ext = extended(m - 2, 5, 0x20)
            out.extend(((dd << 2) & 0xFF, dd >> 6))
            _count(stats, "m3_ext" if ext else "m3")
        else:
            dd = d - 0x4000
            ext = extended(m - 2, 3, 0x10 | ((dd >> 11) & 8))
            out.extend(((dd << 2) & 0xFF, (dd >> 6) & 0xFF))
            _count(stats, "m4_ext" if ext else "m4")
            if dd >= 0x4000:
                _count(stats, "m4_far")  # past 32768
        if d < m:
            _count(stats, "overlap_1" if d == 1 else "overlap")

    def insert(p: int):
        if p + 3 <= n:
            lst = heads.get(data[p:p + 3])
            if lst is None:
                heads[data[p:p + 3]] = [p]
            else:
                lst.append(p)
                if len(lst) > KEEP:
                    del lst[0]
        pairs[data[p:p + 2]] = p

    i = lit = 0  # lit: the first pending literal
    while i + 2 < n:
        best, dist = 0, 0
        for p in reversed(heads.get(data[i:i + 3], ())[-CHAIN:]):
            d = i - p
            if d > M4_MAX_OFFSET:
                break
            if best and (i + best >= n or data[p + best] != data[i + best]):
                continue  # cannot be longer
            m = _common(data, i, p, n - i)
            if m > best:
                best, dist = m, d
        pending = i - lit
        ok = best >= 4
        if best == 3:
            ok = dist <= M2_MAX_OFFSET or (
                1 <= pending <= 3 and M2_MAX_OFFSET < dist <= 3072)
        if not ok and pending >= 4 and data[i + 2:i + 5] in heads:
            # a 2-byte M1 pays only when a match may follow it
            p = pairs.get(data[i:i + 2])
            if p is not None and i - p <= 1024:
                ok, best, dist = True, 2, i - p
        if not ok:
            insert(i)
            i += 1
            continue
        literals(lit, i)
        match(dist, best)
        for p in range(i, i + min(best, 8)):  # a match's first positions
            insert(p)
        i += best
        lit = i
    literals(lit, n)
    out.extend(b"\x11\x00\x00")
    _count(stats, "end")
    return bytes(out)


# --- ORC ---------------------------------------------------------------------

def _fields(buf: bytes) -> list:
    """A protobuf message as [field, wire type, value] triples."""
    out, pos = [], 0

    def varint():
        nonlocal pos
        r = shift = 0
        while True:
            b = buf[pos]
            pos += 1
            r |= (b & 0x7F) << shift
            if not b & 0x80:
                return r
            shift += 7

    while pos < len(buf):
        key = varint()
        f, wt = key >> 3, key & 7
        if wt == 0:
            v = varint()
        elif wt == 2:
            ln = varint()
            v, pos = bytes(buf[pos:pos + ln]), pos + ln
        else:
            w = 8 if wt == 1 else 4
            v, pos = bytes(buf[pos:pos + w]), pos + w
        out.append([f, wt, v])
    return out


def _encode(fields: list) -> bytes:
    def varint(v):
        out = bytearray()
        while True:
            out.append((v & 0x7F) | (0x80 if v >> 7 else 0))
            v >>= 7
            if not v:
                return bytes(out)

    out = bytearray()
    for f, wt, v in fields:
        out += varint(f << 3 | wt)
        out += (varint(v) if wt == 0 else
                varint(len(v)) + v if wt == 2 else v)
    return bytes(out)


def _get(fields: list, f: int, default=None):
    vals = [v for g, _, v in fields if g == f]
    return vals[-1] if vals else default


def _set(fields: list, f: int, v) -> list:
    return [[g, wt, v if g == f else x] for g, wt, x in fields]


def _inflate(region: bytes) -> bytes:
    """A ZLIB ORC region: chunks under 3-byte headers, raw deflate or
    stored ("original")."""
    out, pos = [], 0
    while pos < len(region):
        h = region[pos] | region[pos + 1] << 8 | region[pos + 2] << 16
        pos += 3
        chunk = region[pos:pos + (h >> 1)]
        pos += h >> 1
        out.append(chunk if h & 1 else zlib.decompress(chunk, -15))
    return b"".join(out)


def _header(length: int, original: bool) -> bytes:
    h = length << 1 | original
    return bytes((h & 0xFF, h >> 8 & 0xFF, h >> 16))


def _lzo(plain: bytes, block: int) -> bytes:
    """`plain` as ORC LZO chunks of at most `block` bytes each."""
    out = bytearray()
    for at in range(0, len(plain), block):
        raw = plain[at:at + block]
        z = lzo1x_compress(raw)
        out += (_header(len(z), False) + z if len(z) < len(raw)
                else _header(len(raw), True) + raw)
    return bytes(out)


def orc_to_lzo(src: str, dst: str, data_block: bytes | None = None):
    """Rewrite the ZLIB ORC file `src` as ORC LZO at `dst` (see the module
    docstring)."""
    raw = open(src, "rb").read()
    ps_len = raw[-1]
    ps = _fields(raw[-1 - ps_len:-1])
    if _get(ps, 2) != 1:
        raise ValueError(f"{src}: not a ZLIB ORC file")
    block = _get(ps, 3, 256 * 1024)
    flen, mlen = _get(ps, 1), _get(ps, 5, 0)
    fstart = len(raw) - 1 - ps_len - flen
    footer = _fields(_inflate(raw[fstart:fstart + flen]))
    mstart = fstart - mlen
    if _get(footer, 2) != mstart - 3:  # contentLength: after "ORC"
        raise ValueError(f"{src}: the stripes do not end at the metadata")
    stride = _get(footer, 8, 0)
    out = bytearray(raw[:3])  # "ORC"
    stripes = []
    for f, wt, v in footer:
        if f != 3:
            continue
        st = _fields(v)
        off, ilen, dlen = _get(st, 1), _get(st, 2, 0), _get(st, 3, 0)
        sflen, rows = _get(st, 4), _get(st, 5)
        if stride and stride < rows:
            raise ValueError(
                f"{src}: {rows} rows in a stripe and row_index_stride "
                f"{stride}: the row-index positions of later row groups "
                "would go stale; write it with row_index_stride >= the "
                "stripe's rows")
        at = off + ilen + dlen  # the stripe footer
        sf = _fields(_inflate(raw[at:at + sflen]))
        pos, ilen2, dlen2, body, new_sf = off, 0, 0, bytearray(), []
        for g, gwt, gv in sf:
            if g != 1:
                new_sf.append([g, gwt, gv])
                continue
            s = _fields(gv)
            kind, col, ln = _get(s, 1, 0), _get(s, 2, 0), _get(s, 3, 0)
            if data_block is not None and (kind, col) == (1, 1):
                z = _header(len(data_block), False) + data_block
            else:
                z = _lzo(_inflate(raw[pos:pos + ln]), block)
            if pos - off < ilen:
                ilen2 += len(z)
            else:
                dlen2 += len(z)
            pos += ln
            body += z
            new_sf.append([g, gwt, _encode(_set(s, 3, len(z)))])
        sfz = _lzo(_encode(new_sf), block)
        st = _set(_set(_set(_set(st, 1, len(out)), 2, ilen2), 3, dlen2),
                  4, len(sfz))
        stripes.append(_encode(st))
        out += body + sfz
    content = len(out)
    out += _lzo(_inflate(raw[mstart:fstart]), block)
    it = iter(stripes)
    footer = [[f, wt, next(it) if f == 3 else v] for f, wt, v in footer]
    fz = _lzo(_encode(_set(footer, 2, content - 3)), block)
    new_ps = _encode(_set(_set(_set(ps, 1, len(fz)), 2, 3), 5,
                          len(out) - content))
    out += fz + new_ps + bytes([len(new_ps)])
    with open(dst, "wb") as fh:
        fh.write(out)
    if data_block is None:
        import pyarrow.orc as po

        if not po.ORCFile(dst).read().equals(po.ORCFile(src).read()):
            raise AssertionError(f"{dst}: pyarrow reads another table "
                                 f"than {src}'s")
