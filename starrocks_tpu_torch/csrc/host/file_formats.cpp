// The hot loops of the port's parquet and ORC readers
// (storage/formats/parquet.py, storage/formats/orc.py), built on its own at
// first use by starrocks_tpu_torch/native.py. The readers parse footers and
// page headers in Python; every loop over values runs here.
//
// sr_snappy_decompress: the raw snappy block format (parquet's SNAPPY
//   pages; each chunk of an ORC SNAPPY stream).
// sr_rle_bp_decode: parquet's RLE/bit-packed hybrid (definition levels and
//   dictionary indices), values of up to 32 bits.
// sr_byte_array_offsets: parquet's PLAIN BYTE_ARRAY, 4-byte little-endian
//   lengths each followed by the bytes, split into (start, end) offsets.
// sr_delta_binary_packed: parquet's DELTA_BINARY_PACKED (INT32, INT64 and
//   the lengths of the two DELTA byte-array encodings): blocks of
//   miniblocks, bit widths 0-64, deltas that wrap in unsigned 64 bits.
// sr_delta_byte_array: parquet's DELTA_BYTE_ARRAY, each value the previous
//   one's prefix plus its own suffix, rebuilt into one contiguous buffer.
// sr_orc_rle_v1: ORC's integer run-length encoding v1 (file version 0.11):
//   runs with a signed delta byte, and literals.
// sr_orc_varints: the zigzag base-128 varints of ORC's DECIMAL values, up
//   to 128 bits each, as two's complement (high, low) 64-bit halves.
// sr_orc_rle_v2: ORC's integer run-length encoding v2, all four
//   sub-encodings (SHORT_REPEAT, DIRECT, PATCHED_BASE, DELTA), signed
//   (zigzag) or unsigned.
// sr_orc_byte_rle: ORC's byte run-length encoding (BYTE columns, and the
//   bytes of boolean streams before they are split into bits).
//
// Each returns the input bytes it consumed, or -1 when the input is cut
// short or malformed; the readers raise on -1.
//
// The TabletStore's parquet writer (storage/formats/parquet_write.py) has
// its loops here as well:
// sr_snappy_compress: the raw snappy block format, from the format's
//   description: the varint of the uncompressed length, then literals and
//   copies with 1- and 2-byte offsets, found by a greedy hash-table matcher
//   over 64 KiB blocks (the table reset per block, so no offset reaches
//   65,536 and no 4-byte-offset copy is written), with the matcher's
//   skipping of incompressible input. Returns the bytes written, or -1 when
//   `cap` is below sr_snappy_max_compressed(n).
// sr_rle_hybrid_encode: values of `width` (0-32) bits (uint8 or uint32
//   input) in the RLE/bit-packed hybrid, as Arrow's encoder lays it out:
//   groups of 8 from the end of the last repeated run; a group that starts
//   8 or more equal values starts a repeated run, which lasts as long as
//   the value repeats; other groups go into bit-packed runs of at most 63
//   groups (the last group padded with zeros); input that ends in values
//   all equal with no bit-packed run open ends in a repeated run. Returns
//   the bytes written, or -1 when `cap` is too small.
// sr_dict_encode_fixed: the dictionary of values `width` bytes wide, in
//   order of first appearance (an open-addressing hash over the bytes):
//   each value's index, and the row of each dictionary entry's first
//   appearance. At each check position (sorted value counts), a dictionary
//   of `max_entries` or more stops the encoding: the values from there on
//   are left to PLAIN pages. Returns the entries, the values encoded in
//   *n_encoded; -1 when memory runs out.
// sr_plain_byte_arrays: the strings buf[offs[r]] of the rows `rows`, each
//   after its 4-byte little-endian length (PLAIN BYTE_ARRAY); the bytes
//   written.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// --- snappy ------------------------------------------------------------------

int64_t sr_snappy_decompress(const uint8_t* in, int64_t n, uint8_t* out,
                             int64_t cap) {
  int64_t i = 0;
  uint64_t want = 0;
  for (int shift = 0;; shift += 7) {
    if (i >= n || shift > 63) return -1;
    uint8_t b = in[i++];
    want |= (uint64_t)(b & 0x7f) << shift;
    if (!(b & 0x80)) break;
  }
  if ((int64_t)want > cap) return -1;
  int64_t o = 0;
  while (i < n) {
    uint8_t tag = in[i++];
    int64_t len, off;
    switch (tag & 3) {
      case 0: {  // literal
        len = (tag >> 2) + 1;
        if (len > 60) {
          int nb = (int)len - 60;
          if (i + nb > n) return -1;
          len = 0;
          for (int k = 0; k < nb; k++) len |= (int64_t)in[i + k] << (8 * k);
          len += 1;
          i += nb;
        }
        if (i + len > n || o + len > (int64_t)want) return -1;
        memcpy(out + o, in + i, (size_t)len);
        i += len;
        o += len;
        continue;
      }
      case 1:
        if (i >= n) return -1;
        len = ((tag >> 2) & 7) + 4;
        off = ((int64_t)(tag >> 5) << 8) | in[i++];
        break;
      case 2:
        if (i + 2 > n) return -1;
        len = (tag >> 2) + 1;
        off = (int64_t)in[i] | ((int64_t)in[i + 1] << 8);
        i += 2;
        break;
      default:
        if (i + 4 > n) return -1;
        len = (tag >> 2) + 1;
        off = (int64_t)in[i] | ((int64_t)in[i + 1] << 8) |
              ((int64_t)in[i + 2] << 16) | ((int64_t)in[i + 3] << 24);
        i += 4;
        break;
    }
    if (off <= 0 || off > o || o + len > (int64_t)want) return -1;
    // byte by byte: a copy may overlap its own output (off < len)
    for (int64_t k = 0; k < len; k++) out[o + k] = out[o - off + k];
    o += len;
  }
  return o == (int64_t)want ? o : -1;
}

// --- parquet -----------------------------------------------------------------

static inline bool read_uvarint(const uint8_t* in, int64_t n, int64_t* i,
                                uint64_t* v) {
  uint64_t r = 0;
  for (int shift = 0; shift < 64; shift += 7) {
    if (*i >= n) return false;
    uint8_t b = in[(*i)++];
    r |= (uint64_t)(b & 0x7f) << shift;
    if (!(b & 0x80)) {
      *v = r;
      return true;
    }
  }
  return false;
}

// up to 8 little-endian bytes of p[at..n), zeros past n
static inline uint64_t load_le(const uint8_t* p, int64_t n, int64_t at) {
  uint64_t w = 0;
  if (at + 8 <= n) {
    memcpy(&w, p + at, 8);
  } else {
    for (int64_t k = 0; at + k < n; k++) w |= (uint64_t)p[at + k] << (8 * k);
  }
  return w;
}

// value of `width` (0-64) bits at bit `bit` of p[0..n), LSB first
static inline uint64_t bits_le(const uint8_t* p, int64_t n, int64_t bit,
                               int width) {
  if (width == 0) return 0;
  const int sh = (int)(bit & 7);
  uint64_t lo = load_le(p, n, bit >> 3) >> sh;
  if (width + sh > 64) lo |= load_le(p, n, (bit >> 3) + 8) << (64 - sh);
  return width == 64 ? lo : lo & ((1ULL << width) - 1);
}

int64_t sr_rle_bp_decode(const uint8_t* in, int64_t n, int32_t bit_width,
                         int64_t count, int32_t* out) {
  int64_t i = 0, o = 0;
  const int vbytes = (bit_width + 7) / 8;
  const uint64_t mask =
      bit_width >= 32 ? 0xffffffffULL : ((1ULL << bit_width) - 1);
  while (o < count) {
    uint64_t h;
    if (!read_uvarint(in, n, &i, &h)) return -1;
    if (h & 1) {  // bit-packed: (h >> 1) groups of 8 values
      int64_t vals = (int64_t)(h >> 1) * 8;
      int64_t nbytes = (int64_t)(h >> 1) * bit_width;
      if (i + nbytes > n) return -1;
      const uint8_t* p = in + i;
      for (int64_t k = 0; k < vals && o < count; k++) {
        int64_t bit = k * bit_width;
        uint64_t v = load_le(p, nbytes, bit >> 3) >> (bit & 7);
        out[o++] = (int32_t)(v & mask);
      }
      i += nbytes;
    } else {  // run: (h >> 1) copies of one value
      int64_t run = (int64_t)(h >> 1);
      if (i + vbytes > n) return -1;
      uint64_t v = 0;
      for (int k = 0; k < vbytes; k++) v |= (uint64_t)in[i + k] << (8 * k);
      i += vbytes;
      for (int64_t k = 0; k < run && o < count; k++) out[o++] = (int32_t)v;
    }
  }
  return i;
}

int64_t sr_byte_array_offsets(const uint8_t* in, int64_t n, int64_t count,
                              int64_t base, int64_t* offs) {
  int64_t i = 0;
  for (int64_t k = 0; k < count; k++) {
    if (i + 4 > n) return -1;
    uint32_t m;
    memcpy(&m, in + i, 4);
    i += 4;
    if (i + (int64_t)m > n) return -1;
    offs[2 * k] = base + i;
    offs[2 * k + 1] = base + i + m;
    i += m;
  }
  return i;
}

static inline bool read_zigzag(const uint8_t* in, int64_t n, int64_t* i,
                               uint64_t* v) {
  uint64_t u;
  if (!read_uvarint(in, n, i, &u)) return false;
  *v = (u >> 1) ^ (0 - (u & 1));
  return true;
}

int64_t sr_delta_binary_packed(const uint8_t* in, int64_t n, int64_t count,
                               int64_t* out) {
  int64_t i = 0;
  uint64_t block, nmini, total, first;
  if (!read_uvarint(in, n, &i, &block) || !read_uvarint(in, n, &i, &nmini) ||
      !read_uvarint(in, n, &i, &total) || !read_zigzag(in, n, &i, &first))
    return -1;
  if (block == 0 || nmini == 0 || block % 128 || block % nmini ||
      (block / nmini) % 32 || (int64_t)total < count)
    return -1;
  const int64_t per_mini = (int64_t)(block / nmini);
  uint64_t v = first;
  int64_t o = 0;
  if (count > 0) out[o++] = (int64_t)v;
  if (total <= 1) return i;
  int64_t left = (int64_t)total - 1;  // values still encoded
  while (left > 0) {
    uint64_t min_delta;
    if (!read_zigzag(in, n, &i, &min_delta)) return -1;
    if (i + (int64_t)nmini > n) return -1;
    const uint8_t* widths = in + i;
    i += (int64_t)nmini;
    for (uint64_t m = 0; m < nmini && left > 0; m++) {
      const int w = widths[m];
      if (w > 64) return -1;
      const int64_t nbytes = per_mini * w / 8;
      if (i + nbytes > n) return -1;
      const uint8_t* p = in + i;
      const int64_t take = left < per_mini ? left : per_mini;
      for (int64_t k = 0; k < take; k++) {
        v += min_delta + bits_le(p, nbytes, k * w, w);  // wraps mod 2^64
        if (o < count) out[o++] = (int64_t)v;
      }
      left -= take;
      i += nbytes;
    }
  }
  return i;
}

int64_t sr_delta_byte_array(const uint8_t* data, const int64_t* prefix,
                            const int64_t* soffs, int64_t count, uint8_t* out,
                            int64_t cap, int64_t* offs) {
  int64_t o = 0, prev_s = 0, prev_len = 0;
  for (int64_t k = 0; k < count; k++) {
    const int64_t pre = prefix[k];
    const int64_t slen = soffs[2 * k + 1] - soffs[2 * k];
    if (pre < 0 || pre > prev_len || slen < 0 || o + pre + slen > cap)
      return -1;
    memmove(out + o, out + prev_s, (size_t)pre);
    memcpy(out + o + pre, data + soffs[2 * k], (size_t)slen);
    offs[2 * k] = o;
    offs[2 * k + 1] = o + pre + slen;
    prev_s = o;
    prev_len = pre + slen;
    o += prev_len;
  }
  return o;
}

// --- ORC ---------------------------------------------------------------------

static const int kWidths[32] = {1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11,
                                12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
                                23, 24, 26, 28, 30, 32, 40, 48, 56, 64};

static inline int closest_fixed_bits(int w) {
  if (w == 0) return 1;
  if (w <= 24) return w;
  if (w <= 26) return 26;
  if (w <= 28) return 28;
  if (w <= 30) return 30;
  if (w <= 32) return 32;
  if (w <= 40) return 40;
  if (w <= 48) return 48;
  if (w <= 56) return 56;
  return 64;
}

static inline int64_t unzigzag(uint64_t v) {
  return (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
}

// MSB-first bit-packed values of `width` bits, byte aligned at the start
static bool read_packed(const uint8_t* in, int64_t n, int64_t* i, int width,
                        int64_t count, uint64_t* out) {
  int64_t nbits = count * width;
  int64_t nbytes = (nbits + 7) / 8;
  if (*i + nbytes > n) return false;
  const uint8_t* p = in + *i;
  int64_t bit = 0;
  for (int64_t k = 0; k < count; k++) {
    uint64_t v = 0;
    for (int b = 0; b < width; b++, bit++)
      v = (v << 1) | ((p[bit >> 3] >> (7 - (bit & 7))) & 1);
    out[k] = v;
  }
  *i += nbytes;
  return true;
}

int64_t sr_orc_rle_v2(const uint8_t* in, int64_t n, int32_t is_signed,
                      int64_t count, int64_t* out) {
  int64_t i = 0, o = 0;
  std::vector<uint64_t> tmp;
  while (o < count) {
    if (i >= n) return -1;
    uint8_t b0 = in[i++];
    int enc = (b0 >> 6) & 3;
    if (enc == 0) {  // SHORT_REPEAT
      int width = ((b0 >> 3) & 7) + 1;
      int64_t run = (b0 & 7) + 3;
      if (i + width > n) return -1;
      uint64_t v = 0;
      for (int k = 0; k < width; k++) v = (v << 8) | in[i + k];
      i += width;
      int64_t x = is_signed ? unzigzag(v) : (int64_t)v;
      for (int64_t k = 0; k < run && o < count; k++) out[o++] = x;
      continue;
    }
    if (i >= n) return -1;
    int64_t len = ((int64_t)(b0 & 1) << 8 | in[i++]) + 1;
    int wcode = (b0 >> 1) & 0x1f;
    if (enc == 1) {  // DIRECT
      int width = kWidths[wcode];
      tmp.resize(len);
      if (!read_packed(in, n, &i, width, len, tmp.data())) return -1;
      for (int64_t k = 0; k < len && o < count; k++)
        out[o++] = is_signed ? unzigzag(tmp[k]) : (int64_t)tmp[k];
    } else if (enc == 2) {  // PATCHED_BASE
      int width = kWidths[wcode];
      if (i + 2 > n) return -1;
      uint8_t b2 = in[i++], b3 = in[i++];
      int bw = ((b2 >> 5) & 7) + 1;
      int pw = kWidths[b2 & 0x1f];
      int pgw = ((b3 >> 5) & 7) + 1;
      int pll = b3 & 0x1f;
      if (i + bw > n) return -1;
      uint64_t bv = 0;
      for (int k = 0; k < bw; k++) bv = (bv << 8) | in[i + k];
      i += bw;
      uint64_t sign = 1ULL << (bw * 8 - 1);
      int64_t base = (bv & sign) ? -(int64_t)(bv & ~sign) : (int64_t)bv;
      tmp.resize(len);
      if (!read_packed(in, n, &i, width, len, tmp.data())) return -1;
      std::vector<uint64_t> patches(pll);
      if (!read_packed(in, n, &i, closest_fixed_bits(pgw + pw), pll,
                       patches.data()))
        return -1;
      int64_t pos = 0;
      const uint64_t pmask = pw >= 64 ? ~0ULL : ((1ULL << pw) - 1);
      for (int k = 0; k < pll; k++) {
        pos += (int64_t)(patches[k] >> pw);
        uint64_t patch = patches[k] & pmask;
        if (patch == 0) continue;  // a gap longer than 255: no patch
        if (pos >= len) return -1;
        tmp[pos] |= patch << width;
      }
      for (int64_t k = 0; k < len && o < count; k++)
        out[o++] = base + (int64_t)tmp[k];
    } else {  // DELTA
      int width = wcode == 0 ? 0 : kWidths[wcode];
      uint64_t ub;
      if (!read_uvarint(in, n, &i, &ub)) return -1;
      int64_t base = is_signed ? unzigzag(ub) : (int64_t)ub;
      uint64_t ud;
      if (!read_uvarint(in, n, &i, &ud)) return -1;
      int64_t delta = unzigzag(ud);
      int64_t v = base;
      if (o < count) out[o++] = v;
      if (len >= 2) {
        v += delta;
        if (o < count) out[o++] = v;
        if (width == 0) {
          for (int64_t k = 2; k < len; k++) {
            v += delta;
            if (o < count) out[o++] = v;
          }
        } else {
          tmp.resize(len - 2);
          if (!read_packed(in, n, &i, width, len - 2, tmp.data())) return -1;
          for (int64_t k = 0; k < len - 2; k++) {
            v += delta < 0 ? -(int64_t)tmp[k] : (int64_t)tmp[k];
            if (o < count) out[o++] = v;
          }
        }
      }
    }
  }
  return i;
}

int64_t sr_orc_rle_v1(const uint8_t* in, int64_t n, int32_t is_signed,
                      int64_t count, int64_t* out) {
  int64_t i = 0, o = 0;
  while (o < count) {
    if (i >= n) return -1;
    const int8_t h = (int8_t)in[i++];
    if (h >= 0) {  // a run of h + 3 values: a delta byte, then the base
      if (i >= n) return -1;
      const int64_t delta = (int8_t)in[i++];
      uint64_t u;
      if (!read_uvarint(in, n, &i, &u)) return -1;
      uint64_t v = is_signed ? (uint64_t)unzigzag(u) : u;
      for (int k = 0; k < h + 3 && o < count; k++) {
        out[o++] = (int64_t)v;
        v += (uint64_t)delta;
      }
    } else {  // -h literal varints
      for (int k = 0; k < -(int)h && o < count; k++) {
        uint64_t u;
        if (!read_uvarint(in, n, &i, &u)) return -1;
        out[o++] = is_signed ? unzigzag(u) : (int64_t)u;
      }
    }
  }
  return i;
}

int64_t sr_orc_varints(const uint8_t* in, int64_t n, int64_t count,
                       int64_t* hi, int64_t* lo) {
  int64_t i = 0;
  for (int64_t k = 0; k < count; k++) {
    unsigned __int128 u = 0;
    for (int shift = 0;; shift += 7) {
      if (i >= n || shift > 126) return -1;
      const uint8_t b = in[i++];
      u |= (unsigned __int128)(b & 0x7f) << shift;
      if (!(b & 0x80)) break;
    }
    const unsigned __int128 v = (u >> 1) ^ (0 - (u & 1));  // unzigzag
    hi[k] = (int64_t)(uint64_t)(v >> 64);
    lo[k] = (int64_t)(uint64_t)v;
  }
  return i;
}

int64_t sr_orc_byte_rle(const uint8_t* in, int64_t n, int64_t count,
                        uint8_t* out) {
  int64_t i = 0, o = 0;
  while (o < count) {
    if (i >= n) return -1;
    int8_t h = (int8_t)in[i++];
    if (h >= 0) {  // run of h + 3 copies
      if (i >= n) return -1;
      uint8_t v = in[i++];
      for (int k = 0; k < h + 3 && o < count; k++) out[o++] = v;
    } else {  // -h literal bytes
      int64_t m = -(int64_t)h;
      if (i + m > n) return -1;
      for (int64_t k = 0; k < m && o < count; k++) out[o++] = in[i + k];
      i += m;
    }
  }
  return i;
}

// --- the writer's loops ---------------------------------------------------------

static inline uint32_t ld32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

static inline uint64_t ld64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}

// --- snappy compression ----------------------------------------------------------

static const int64_t kSnappyBlock = 1 << 16;
static const int kSnappyMaxTableBits = 14;

int64_t sr_snappy_max_compressed(int64_t n) { return 32 + n + n / 6; }

static inline uint32_t snappy_hash(uint32_t v, int shift) {
  return (v * 0x1e35a7bdU) >> shift;
}

static uint8_t* snappy_literal(uint8_t* op, const uint8_t* lit, int64_t len) {
  int64_t n = len - 1;
  if (n < 60) {
    *op++ = (uint8_t)(n << 2);
  } else {
    uint8_t* tag = op++;
    int count = 0;
    for (; n > 0; n >>= 8, count++) *op++ = (uint8_t)(n & 0xff);
    *tag = (uint8_t)((59 + count) << 2);
  }
  memcpy(op, lit, (size_t)len);
  return op + len;
}

// one copy of 4-64 bytes: 1-byte offset for 4-11 bytes below 2048 back,
// else a 2-byte offset
static uint8_t* snappy_copy64(uint8_t* op, int64_t off, int64_t len) {
  if (len < 12 && off < 2048) {
    *op++ = (uint8_t)(1 | ((len - 4) << 2) | ((off >> 8) << 5));
    *op++ = (uint8_t)(off & 0xff);
  } else {
    *op++ = (uint8_t)(2 | ((len - 1) << 2));
    *op++ = (uint8_t)(off & 0xff);
    *op++ = (uint8_t)((off >> 8) & 0xff);
  }
  return op;
}

static uint8_t* snappy_copy(uint8_t* op, int64_t off, int64_t len) {
  // 64-byte pieces, keeping at least 4 for the last one or two
  while (len >= 68) {
    op = snappy_copy64(op, off, 64);
    len -= 64;
  }
  if (len > 64) {
    op = snappy_copy64(op, off, 60);
    len -= 60;
  }
  return snappy_copy64(op, off, len);
}

// bytes from s2 on equal to those from s1 on, up to end (s1 < s2)
static inline int64_t match_length(const uint8_t* s1, const uint8_t* s2,
                                   const uint8_t* end) {
  int64_t m = 0;
  while (s2 + m + 8 <= end) {
    const uint64_t x = ld64(s2 + m) ^ ld64(s1 + m);
    if (x) return m + (__builtin_ctzll(x) >> 3);
    m += 8;
  }
  while (s2 + m < end && s1[m] == s2[m]) m++;
  return m;
}

// one block of at most 64 KiB; `table` holds 1 << bits entries, zeroed
static uint8_t* snappy_block(const uint8_t* in, int64_t n, uint8_t* op,
                             uint16_t* table, int bits) {
  const uint8_t* ip = in;
  const uint8_t* end = in + n;
  const uint8_t* next_emit = in;
  const int shift = 32 - bits;
  const int64_t kMargin = 15;  // the last bytes are always a literal
  if (n >= kMargin) {
    const uint8_t* limit = end - kMargin;
    uint32_t next_hash = snappy_hash(ld32(++ip), shift);
    for (;;) {
      // look for a 4-byte match, stepping further the longer none is found
      uint32_t skip = 32;
      const uint8_t* next_ip = ip;
      const uint8_t* cand;
      do {
        ip = next_ip;
        const uint32_t h = next_hash;
        const uint32_t step = skip >> 5;
        skip += step;
        next_ip = ip + step;
        if (next_ip > limit) goto tail;
        next_hash = snappy_hash(ld32(next_ip), shift);
        cand = in + table[h];
        table[h] = (uint16_t)(ip - in);
      } while (ld32(ip) != ld32(cand));
      op = snappy_literal(op, next_emit, ip - next_emit);
      // copies, as long as the bytes after one match start another
      uint64_t at;
      uint32_t cand_bytes;
      do {
        const uint8_t* base = ip;
        const int64_t len = 4 + match_length(cand + 4, ip + 4, end);
        ip += len;
        op = snappy_copy(op, base - cand, len);
        next_emit = ip;
        if (ip >= limit) goto tail;
        at = ld64(ip - 1);
        table[snappy_hash((uint32_t)at, shift)] = (uint16_t)(ip - 1 - in);
        const uint32_t h = snappy_hash((uint32_t)(at >> 8), shift);
        cand = in + table[h];
        cand_bytes = ld32(cand);
        table[h] = (uint16_t)(ip - in);
      } while ((uint32_t)(at >> 8) == cand_bytes);
      next_hash = snappy_hash((uint32_t)(at >> 16), shift);
      ++ip;
    }
  }
tail:
  if (next_emit < end) op = snappy_literal(op, next_emit, end - next_emit);
  return op;
}

int64_t sr_snappy_compress(const uint8_t* in, int64_t n, uint8_t* out,
                           int64_t cap) {
  if (n < 0 || cap < sr_snappy_max_compressed(n)) return -1;
  uint8_t* op = out;
  for (uint64_t v = (uint64_t)n;; v >>= 7) {
    if (v < 0x80) {
      *op++ = (uint8_t)v;
      break;
    }
    *op++ = (uint8_t)((v & 0x7f) | 0x80);
  }
  std::vector<uint16_t> table((size_t)1 << kSnappyMaxTableBits);
  for (int64_t at = 0; at < n; at += kSnappyBlock) {
    const int64_t m = n - at < kSnappyBlock ? n - at : kSnappyBlock;
    int bits = 8;
    while (bits < kSnappyMaxTableBits && ((int64_t)1 << bits) < m) bits++;
    memset(table.data(), 0, sizeof(uint16_t) << bits);
    op = snappy_block(in + at, m, op, table.data(), bits);
  }
  return op - out;
}

// --- the RLE/bit-packed hybrid ------------------------------------------------------

static inline uint8_t* put_uvarint(uint8_t* op, uint64_t v) {
  while (v >= 0x80) {
    *op++ = (uint8_t)((v & 0x7f) | 0x80);
    v >>= 7;
  }
  *op++ = (uint8_t)v;
  return op;
}

}  // extern "C"

template <typename T>
static int64_t rle_hybrid(const T* v, int64_t n, int width, uint8_t* out,
                          int64_t cap) {
  const int vbytes = (width + 7) / 8;
  const uint64_t mask = width >= 32 ? 0xffffffffULL : ((1ULL << width) - 1);
  uint8_t* op = out;
  uint8_t* const stop = out + cap;
  // 8 equal values from p on
  auto run8 = [&](int64_t p) {
    if (p + 8 > n) return false;
    for (int k = 1; k < 8; k++)
      if (v[p + k] != v[p]) return false;
    return true;
  };
  int64_t pos = 0;
  while (pos < n) {
    int64_t r = 1;
    while (pos + r < n && v[pos + r] == v[pos]) r++;
    if (r >= 8 || pos + r == n) {  // a repeated run
      if (stop - op < 10 + vbytes) return -1;
      op = put_uvarint(op, (uint64_t)r << 1);
      const uint64_t x = (uint64_t)v[pos] & mask;
      for (int k = 0; k < vbytes; k++) *op++ = (uint8_t)(x >> (8 * k));
      pos += r;
      continue;
    }
    // a bit-packed run: groups of 8 until one starts a repeated run
    const int64_t start = pos;
    int64_t groups = 0;
    while (pos < n && groups < 63) {
      if (groups > 0 && run8(pos)) break;
      pos += 8;
      groups++;
    }
    if (pos > n) pos = n;
    if (stop - op < 1 + groups * width) return -1;
    *op++ = (uint8_t)((groups << 1) | 1);
    uint64_t acc = 0;
    int bits = 0;
    for (int64_t k = start; k < start + groups * 8; k++) {
      const uint64_t x = k < pos ? ((uint64_t)v[k] & mask) : 0;
      acc |= x << bits;
      bits += width;
      while (bits >= 8) {
        *op++ = (uint8_t)acc;
        acc >>= 8;
        bits -= 8;
      }
    }
  }
  return op - out;
}

extern "C" {

int64_t sr_rle_hybrid_encode(const void* v, int32_t in_bytes, int64_t n,
                             int32_t width, uint8_t* out, int64_t cap) {
  if (width < 0 || width > 32) return -1;
  if (in_bytes == 1)
    return rle_hybrid((const uint8_t*)v, n, width, out, cap);
  if (in_bytes == 4)
    return rle_hybrid((const uint32_t*)v, n, width, out, cap);
  return -1;
}

// --- dictionaries of fixed-width values --------------------------------------------

static inline uint64_t mix64(uint64_t z) {
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

static inline uint64_t hash_value(const uint8_t* p, int w) {
  if (w == 4) return mix64(ld32(p) + 0x9E3779B97F4A7C15ULL);
  if (w == 8) return mix64(ld64(p) + 0x9E3779B97F4A7C15ULL);
  uint64_t h = 0x9E3779B97F4A7C15ULL ^ (uint64_t)w;
  int k = 0;
  for (; k + 8 <= w; k += 8) h = mix64(h ^ ld64(p + k));
  if (k < w) {
    uint64_t t = 0;
    memcpy(&t, p + k, (size_t)(w - k));
    h = mix64(h ^ t);
  }
  return h;
}

int64_t sr_dict_encode_fixed(const uint8_t* vals, int64_t n, int32_t width,
                             const int64_t* checks, int64_t nchecks,
                             int64_t max_entries, uint32_t* index,
                             int64_t* firsts, int64_t* n_encoded) {
  const size_t w = (size_t)width;
  std::vector<int64_t> slots;  // entry id, or -1
  uint64_t cap = 1024;
  try {
    slots.assign(cap, -1);
  } catch (...) {
    return -1;
  }
  int64_t nd = 0, ci = 0;
  *n_encoded = n;
  for (int64_t i = 0; i < n; i++) {
    while (ci < nchecks && checks[ci] <= i) {
      if (checks[ci++] == i && nd >= max_entries) {
        *n_encoded = i;
        return nd;
      }
    }
    const uint8_t* p = vals + (size_t)i * w;
    uint64_t s = hash_value(p, width) & (cap - 1);
    int64_t id;
    for (;;) {
      id = slots[s];
      if (id < 0 || memcmp(vals + (size_t)firsts[id] * w, p, w) == 0) break;
      s = (s + 1) & (cap - 1);
    }
    if (id < 0) {
      id = nd++;
      firsts[id] = i;
      slots[s] = id;
      if ((uint64_t)nd * 2 > cap) {  // grow: rehash every entry
        cap <<= 1;
        try {
          slots.assign(cap, -1);
        } catch (...) {
          return -1;
        }
        for (int64_t e = 0; e < nd; e++) {
          uint64_t t =
              hash_value(vals + (size_t)firsts[e] * w, width) & (cap - 1);
          while (slots[t] >= 0) t = (t + 1) & (cap - 1);
          slots[t] = e;
        }
      }
    }
    index[i] = (uint32_t)id;
  }
  return nd;
}

int64_t sr_plain_byte_arrays(const uint8_t* buf, const int64_t* offs,
                             const int64_t* rows, int64_t count,
                             uint8_t* out) {
  int64_t o = 0;
  for (int64_t k = 0; k < count; k++) {
    const int64_t r = rows[k];
    const int64_t s = offs[2 * r], e = offs[2 * r + 1];
    const uint32_t len = (uint32_t)(e - s);
    memcpy(out + o, &len, 4);
    memcpy(out + o + 4, buf + s, (size_t)len);
    o += 4 + (int64_t)len;
  }
  return o;
}

}  // extern "C"
