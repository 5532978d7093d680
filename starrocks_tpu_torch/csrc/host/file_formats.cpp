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
// two loops here as well, each returning the bytes it wrote:
// sr_bit_pack: values of `width` (1-32) bits packed LSB first, the body of
//   a bit-packed run of the RLE/bit-packed hybrid (levels, dictionary
//   indices); the last group of 8 is padded with zeros.
// sr_plain_byte_arrays: the strings buf[offs[r]] of the rows `rows`, each
//   after its 4-byte little-endian length (PLAIN BYTE_ARRAY).

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

int64_t sr_bit_pack(const uint32_t* v, int64_t count, int32_t width,
                    uint8_t* out) {
  const int64_t nbytes = (count + 7) / 8 * width;
  memset(out, 0, nbytes);
  uint64_t acc = 0;
  int bits = 0;
  int64_t o = 0;
  const uint64_t mask = width >= 32 ? 0xffffffffULL : ((1ULL << width) - 1);
  for (int64_t k = 0; k < count; k++) {
    acc |= ((uint64_t)v[k] & mask) << bits;
    bits += width;
    while (bits >= 8) {
      out[o++] = (uint8_t)acc;
      acc >>= 8;
      bits -= 8;
    }
  }
  if (bits > 0) out[o++] = (uint8_t)acc;
  return nbytes;
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
