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
// sr_orc_rle_v2: ORC's integer run-length encoding v2, all four
//   sub-encodings (SHORT_REPEAT, DIRECT, PATCHED_BASE, DELTA), signed
//   (zigzag) or unsigned.
// sr_orc_byte_rle: ORC's byte run-length encoding (BYTE columns, and the
//   bytes of boolean streams before they are split into bits).
//
// Each returns the input bytes it consumed, or -1 when the input is cut
// short or malformed; the readers raise on -1.

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
        uint64_t v = 0;
        for (int b = 0; b < bit_width; b++) {
          int64_t q = bit + b;
          v |= (uint64_t)((p[q >> 3] >> (q & 7)) & 1) << b;
        }
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

}  // extern "C"
