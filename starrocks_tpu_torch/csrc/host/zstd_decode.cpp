// A Zstandard decoder written from RFC 8878, for the port's parquet (codec
// ZSTD) and ORC (codec ZSTD) readers; built on its own at first use by
// starrocks_tpu_torch/native.py (`zstd_decompress`). No dictionary: a frame
// that names one is refused.
//
// sr_zstd_decompress(in, n, out, cap): every frame of `in` (Zstandard frames
//   and skippable frames, concatenated) into `out`. Returns the bytes
//   written, or a negative code: -1 malformed or truncated input, -2 a
//   content checksum that does not match, -3 more output than `cap`, -4 a
//   frame that needs a dictionary.
//
// The decoder follows the RFC's sections: frame header (3.1.1.1), blocks
// (3.1.1.2), literals (3.1.1.3.1) with Huffman coding (4.2), sequences
// (3.1.1.3.2) with FSE tables (4.1), sequence execution (3.1.1.4), the
// repeat offsets (3.1.1.5) and the XXH64 content checksum.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Fail {
  int code;
};

[[noreturn]] inline void fail(int code = -1) { throw Fail{code}; }

inline int highbit(uint64_t v) { return 63 - __builtin_clzll(v); }

// --- bit streams -------------------------------------------------------------

// Forward little-endian bits (FSE table descriptions).
struct FwdBits {
  const uint8_t* p;
  int64_t n;     // bytes
  int64_t bit;   // next bit to read
  uint32_t read(int nb) {
    uint32_t v = 0;
    for (int k = 0; k < nb; k++, bit++) {
      if ((bit >> 3) >= n) fail();
      v |= (uint32_t)((p[bit >> 3] >> (bit & 7)) & 1) << k;
    }
    return v;
  }
  int64_t bytes_used() const { return (bit + 7) >> 3; }
};

// Backward bits (Huffman streams, FSE streams, the sequences' stream): read
// from the last byte down, starting below the highest set bit of the last
// byte. Bits below the start of the stream read as zeros; `pos` then goes
// negative, which the callers check.
struct BackBits {
  const uint8_t* p;
  int64_t n;
  int64_t pos;  // bits still above the start of the stream
  void init(const uint8_t* src, int64_t len) {
    if (len <= 0) fail();
    p = src;
    n = len;
    uint8_t last = src[len - 1];
    if (!last) fail();
    pos = len * 8 - (8 - highbit(last));
  }
  inline uint64_t load(int64_t byte) const {
    uint64_t w = 0;
    if (byte + 8 <= n) {
      memcpy(&w, p + byte, 8);
    } else {
      for (int64_t k = 0; byte + k < n; k++)
        w |= (uint64_t)p[byte + k] << (8 * k);
    }
    return w;
  }
  inline uint64_t read(int nb) {
    if (nb == 0) return 0;
    pos -= nb;
    if (pos >= 0) {
      uint64_t w = load(pos >> 3) >> (pos & 7);
      return w & ((nb >= 64) ? ~0ULL : ((1ULL << nb) - 1));
    }
    int have = (int)(pos + nb);  // bits at or above position 0
    if (have <= 0) return 0;
    uint64_t w = load(0) & ((1ULL << have) - 1);
    return w << (nb - have);
  }
};

// --- FSE (4.1) ---------------------------------------------------------------

struct FseTable {
  int log = 0;
  std::vector<uint8_t> sym;
  std::vector<uint8_t> bits;
  std::vector<uint16_t> base;
  bool ready = false;
};

void fse_build(FseTable& t, const int16_t* norm, int nsym, int log) {
  const int size = 1 << log;
  t.log = log;
  t.sym.assign(size, 0);
  t.bits.assign(size, 0);
  t.base.assign(size, 0);
  std::vector<uint32_t> next(nsym > 0 ? nsym : 1, 0);
  int high = size;
  for (int s = 0; s < nsym; s++) {
    if (norm[s] == -1) {
      if (high <= 0) fail();
      t.sym[--high] = (uint8_t)s;
      next[s] = 1;
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3;
  const int mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; s++) {
    if (norm[s] <= 0) continue;
    next[s] = (uint32_t)norm[s];
    for (int i = 0; i < norm[s]; i++) {
      t.sym[pos] = (uint8_t)s;
      do {
        pos = (pos + step) & mask;
      } while (pos >= high);
    }
  }
  if (pos != 0) fail();
  for (int i = 0; i < size; i++) {
    uint32_t d = next[t.sym[i]]++;
    int nb = log - highbit(d);
    t.bits[i] = (uint8_t)nb;
    t.base[i] = (uint16_t)((d << nb) - size);
  }
  t.ready = true;
}

void fse_rle(FseTable& t, uint8_t symbol) {
  t.log = 0;
  t.sym.assign(1, symbol);
  t.bits.assign(1, 0);
  t.base.assign(1, 0);
  t.ready = true;
}

// A table description (4.1.1) at src; returns the bytes it took.
int64_t fse_read_table(FseTable& t, const uint8_t* src, int64_t n,
                       int max_log, int max_sym) {
  FwdBits in{src, n, 0};
  int log = (int)in.read(4) + 5;
  if (log > max_log) fail();
  int remaining = 1 << log;
  int16_t norm[256];
  int s = 0;
  while (remaining > 0) {
    if (s > max_sym) fail();
    int nb = highbit((uint64_t)remaining + 1) + 1;
    uint32_t val = in.read(nb);
    const uint32_t lower = (1u << (nb - 1)) - 1;
    const uint32_t threshold = (1u << nb) - 1 - ((uint32_t)remaining + 1);
    if ((val & lower) < threshold) {
      in.bit -= 1;  // a small value: nb - 1 bits
      val &= lower;
    } else if (val > lower) {
      val -= threshold;
    }
    int proba = (int)val - 1;
    remaining -= proba < 0 ? -proba : proba;
    norm[s++] = (int16_t)proba;
    if (proba == 0) {
      uint32_t rep = in.read(2);
      while (true) {
        for (uint32_t k = 0; k < rep; k++) {
          if (s > max_sym) fail();
          norm[s++] = 0;
        }
        if (rep != 3) break;
        rep = in.read(2);
      }
    }
  }
  if (remaining != 0) fail();
  fse_build(t, norm, s, log);
  return in.bytes_used();
}

struct FseState {
  const FseTable* t;
  uint32_t state;
  void init(const FseTable& table, BackBits& br) {
    t = &table;
    state = (uint32_t)br.read(table.log);
  }
  inline uint8_t peek() const { return t->sym[state]; }
  inline void update(BackBits& br) {
    state = t->base[state] + (uint32_t)br.read(t->bits[state]);
  }
};

// --- Huffman (4.2) -----------------------------------------------------------

struct HufTable {
  int max_bits = 0;
  std::vector<uint8_t> sym;
  std::vector<uint8_t> bits;
  bool ready = false;
};

// A tree description (4.2.1) at src; returns the bytes it took.
int64_t huf_read_table(HufTable& h, const uint8_t* src, int64_t n) {
  if (n < 1) fail();
  uint8_t hb = src[0];
  uint8_t w[256];
  int nw = 0;
  int64_t used;
  if (hb < 128) {  // FSE-compressed weights, two interleaved states
    int64_t csize = hb;
    if (csize == 0 || 1 + csize > n) fail();
    FseTable t;
    int64_t th = fse_read_table(t, src + 1, csize, 6, 255);
    if (th >= csize) fail();
    BackBits br;
    br.init(src + 1 + th, csize - th);
    FseState s1, s2;
    s1.init(t, br);
    s2.init(t, br);
    while (true) {
      if (nw >= 255) fail();
      w[nw++] = s1.peek();
      s1.update(br);
      if (br.pos < 0) {
        if (nw >= 255) fail();
        w[nw++] = s2.peek();
        break;
      }
      if (nw >= 255) fail();
      w[nw++] = s2.peek();
      s2.update(br);
      if (br.pos < 0) {
        if (nw >= 255) fail();
        w[nw++] = s1.peek();
        break;
      }
    }
    used = 1 + csize;
  } else {  // direct: 4 bits each, two per byte, high nibble first
    nw = hb - 127;
    int64_t bytes = (nw + 1) / 2;
    if (1 + bytes > n) fail();
    for (int i = 0; i < nw; i++) {
      uint8_t b = src[1 + i / 2];
      w[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
    used = 1 + bytes;
  }
  uint64_t total = 0;
  for (int i = 0; i < nw; i++) {
    if (w[i] > 11) fail();
    if (w[i]) total += 1ULL << (w[i] - 1);
  }
  if (total == 0) fail();
  int max_bits = highbit(total) + 1;
  uint64_t left = (1ULL << max_bits) - total;
  if (left & (left - 1)) fail();  // the last weight must complete a power of 2
  if (nw >= 256) fail();
  w[nw++] = (uint8_t)(highbit(left) + 1);
  if (max_bits > 11) fail();
  uint8_t nbits[256];
  int count[13] = {0};
  for (int i = 0; i < nw; i++) {
    nbits[i] = w[i] ? (uint8_t)(max_bits + 1 - w[i]) : 0;
    count[nbits[i]]++;
  }
  const int size = 1 << max_bits;
  h.max_bits = max_bits;
  h.sym.assign(size, 0);
  h.bits.assign(size, 0);
  int start[13];
  start[max_bits] = 0;
  for (int b = max_bits; b >= 1; b--) {
    start[b - 1] = start[b] + count[b] * (1 << (max_bits - b));
    for (int k = start[b]; k < start[b - 1]; k++) h.bits[k] = (uint8_t)b;
  }
  if (start[0] != size) fail();
  for (int i = 0; i < nw; i++) {
    if (!nbits[i]) continue;
    int len = 1 << (max_bits - nbits[i]);
    int at = start[nbits[i]];
    for (int k = 0; k < len; k++) h.sym[at + k] = (uint8_t)i;
    start[nbits[i]] += len;
  }
  h.ready = true;
  return used;
}

void huf_stream(const HufTable& h, const uint8_t* src, int64_t n, uint8_t* out,
                int64_t count) {
  BackBits br;
  br.init(src, n);
  const uint32_t mask = (1u << h.max_bits) - 1;
  uint32_t state = (uint32_t)br.read(h.max_bits);
  for (int64_t k = 0; k < count; k++) {
    out[k] = h.sym[state];
    int nb = h.bits[state];
    state = ((state << nb) + (uint32_t)br.read(nb)) & mask;
  }
  if (br.pos != -h.max_bits) fail();
}

// --- sequences (3.1.1.3.2) ---------------------------------------------------

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,
                              10, 11, 12,  13,  14,  15,   16,   18,   20,   22,
                              24, 28, 32,  40,  48,  64,   128,  256,  512,  1024,
                              2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,   4,   5,   6,   7,    8,    9,    10,   11,    12,    13,    14,   15, 16,
    17,  18,  19,  20,  21,   22,   23,   24,   25,    26,    27,    28,   29, 30,
    31,  32,  33,  34,  35,   37,   39,   41,   43,    47,    51,    59,   67, 83,
    99,  131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// What persists from block to block within a frame.
struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lits;
};

// One sequence table's mode (3.1.1.3.2.1); returns the bytes it took.
int64_t seq_table(FseTable& t, int mode, const uint8_t* src, int64_t n,
                  const int16_t* norm, int nsym, int dlog, int max_log,
                  int max_sym) {
  switch (mode) {
    case 0:
      fse_build(t, norm, nsym, dlog);
      return 0;
    case 1:
      if (n < 1 || src[0] > max_sym) fail();
      fse_rle(t, src[0]);
      return 1;
    case 2:
      return fse_read_table(t, src, n, max_log, max_sym);
    default:
      if (!t.ready) fail();
      return 0;
  }
}

// A compressed block (3.1.1.3) of `n` bytes; appends to out[*o..cap).
void compressed_block(FrameState& fs, const uint8_t* src, int64_t n,
                      uint8_t* out, int64_t frame_start, int64_t* o,
                      int64_t cap) {
  // literals section
  if (n < 1) fail();
  const int ltype = src[0] & 3;
  const int sfmt = (src[0] >> 2) & 3;
  int64_t hsize, regen, csize = 0;
  if (ltype < 2) {
    if (sfmt == 0 || sfmt == 2) {
      hsize = 1;
      regen = src[0] >> 3;
    } else if (sfmt == 1) {
      hsize = 2;
      if (n < 2) fail();
      regen = (src[0] >> 4) + ((int64_t)src[1] << 4);
    } else {
      hsize = 3;
      if (n < 3) fail();
      regen = (src[0] >> 4) + ((int64_t)src[1] << 4) + ((int64_t)src[2] << 12);
    }
  } else {
    hsize = sfmt < 2 ? 3 : (sfmt == 2 ? 4 : 5);
    if (n < hsize) fail();
    uint64_t h = 0;
    for (int k = 0; k < hsize; k++) h |= (uint64_t)src[k] << (8 * k);
    int w = sfmt < 2 ? 10 : (sfmt == 2 ? 14 : 18);
    regen = (int64_t)((h >> 4) & ((1ULL << w) - 1));
    csize = (int64_t)((h >> (4 + w)) & ((1ULL << w) - 1));
  }
  if (regen > (1 << 17)) fail();
  fs.lits.resize(regen > 0 ? regen : 1);
  uint8_t* lits = fs.lits.data();
  int64_t p = hsize;
  if (ltype == 0) {
    if (p + regen > n) fail();
    memcpy(lits, src + p, regen);
    p += regen;
  } else if (ltype == 1) {
    if (p + 1 > n) fail();
    memset(lits, src[p], regen);
    p += 1;
  } else {
    if (p + csize > n) fail();
    const uint8_t* c = src + p;
    int64_t cn = csize;
    if (ltype == 2) {
      int64_t t = huf_read_table(fs.huf, c, cn);
      c += t;
      cn -= t;
    } else if (!fs.huf.ready) {
      fail();
    }
    if (sfmt == 0) {
      huf_stream(fs.huf, c, cn, lits, regen);
    } else {
      if (cn < 6) fail();
      int64_t s1 = c[0] | (c[1] << 8), s2 = c[2] | (c[3] << 8),
              s3 = c[4] | (c[5] << 8);
      int64_t s4 = cn - 6 - s1 - s2 - s3;
      if (s4 < 1) fail();
      int64_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail();
      const uint8_t* q = c + 6;
      huf_stream(fs.huf, q, s1, lits, seg);
      huf_stream(fs.huf, q + s1, s2, lits + seg, seg);
      huf_stream(fs.huf, q + s1 + s2, s3, lits + 2 * seg, seg);
      huf_stream(fs.huf, q + s1 + s2 + s3, s4, lits + 3 * seg,
                 regen - 3 * seg);
    }
    p += csize;
  }

  // sequences section
  if (p >= n) fail();
  int64_t nseq;
  uint8_t b0 = src[p++];
  if (b0 < 128) {
    nseq = b0;
  } else if (b0 < 255) {
    if (p >= n) fail();
    nseq = ((int64_t)(b0 - 128) << 8) + src[p++];
  } else {
    if (p + 2 > n) fail();
    nseq = src[p] + ((int64_t)src[p + 1] << 8) + 0x7F00;
    p += 2;
  }
  int64_t lp = 0;  // literals consumed
  if (nseq > 0) {
    if (p >= n) fail();
    uint8_t modes = src[p++];
    if (modes & 3) fail();
    p += seq_table(fs.ll, modes >> 6, src + p, n - p, kLLNorm, 36, 6, 9, 35);
    p += seq_table(fs.of, (modes >> 4) & 3, src + p, n - p, kOFNorm, 29, 5, 8,
                   31);
    p += seq_table(fs.ml, (modes >> 2) & 3, src + p, n - p, kMLNorm, 53, 6, 9,
                   52);
    if (p >= n) fail();
    BackBits br;
    br.init(src + p, n - p);
    FseState sll, sof, sml;
    sll.init(fs.ll, br);
    sof.init(fs.of, br);
    sml.init(fs.ml, br);
    for (int64_t k = 0; k < nseq; k++) {
      uint8_t ofc = sof.peek(), mlc = sml.peek(), llc = sll.peek();
      if (ofc > 31 || mlc > 52 || llc > 35) fail();
      uint64_t ofv = (1ULL << ofc) + br.read(ofc);
      uint64_t ml = kMLBase[mlc] + br.read(kMLBits[mlc]);
      uint64_t ll = kLLBase[llc] + br.read(kLLBits[llc]);
      uint64_t off;
      if (ofv > 3) {
        off = ofv - 3;
        fs.rep[2] = fs.rep[1];
        fs.rep[1] = fs.rep[0];
        fs.rep[0] = off;
      } else {
        int idx = (int)ofv - 1 + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          off = fs.rep[0];
        } else {
          off = idx < 3 ? fs.rep[idx] : fs.rep[0] - 1;
          if (idx > 1) fs.rep[2] = fs.rep[1];
          fs.rep[1] = fs.rep[0];
          fs.rep[0] = off;
        }
      }
      if (k + 1 < nseq) {
        sll.update(br);
        sml.update(br);
        sof.update(br);
      }
      // execute (3.1.1.4): literals, then the match
      if ((int64_t)ll > regen - lp) fail();
      if (*o + (int64_t)ll > cap) fail(-3);
      memcpy(out + *o, lits + lp, ll);
      lp += ll;
      *o += ll;
      if (off == 0 || (int64_t)off > *o - frame_start) fail();
      if (*o + (int64_t)ml > cap) fail(-3);
      uint8_t* d = out + *o;
      const uint8_t* s = d - off;
      if (off >= ml) {
        memcpy(d, s, ml);
      } else {
        for (uint64_t i = 0; i < ml; i++) d[i] = s[i];  // overlaps itself
      }
      *o += ml;
    }
    if (br.pos != 0) fail();
  } else if (p != n) {
    fail();
  }
  int64_t rest = regen - lp;
  if (*o + rest > cap) fail(-3);
  memcpy(out + *o, lits + lp, rest);
  *o += rest;
}

// --- XXH64 -------------------------------------------------------------------

const uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
               P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
               P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  acc += in * P2;
  return rotl(acc, 31) * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  acc ^= xround(0, v);
  return acc * P1 + P4;
}
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}
inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

uint64_t xxh64(const uint8_t* p, int64_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* lim = end - 32;
    do {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
      p += 32;
    } while (p <= lim);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1);
    h = xmerge(h, v2);
    h = xmerge(h, v3);
    h = xmerge(h, v4);
  } else {
    h = P5;
  }
  h += (uint64_t)len;
  while (p + 8 <= end) {
    h ^= xround(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)rd32(p) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (uint64_t)(*p) * P5;
    h = rotl(h, 11) * P1;
    p++;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// --- frames (3.1.1) ----------------------------------------------------------

int64_t frame(const uint8_t* in, int64_t n, uint8_t* out, int64_t o,
              int64_t cap, int64_t* used) {
  int64_t i = 4;
  if (i >= n) fail();
  uint8_t fhd = in[i++];
  int fcs_flag = fhd >> 6;
  bool single = (fhd >> 5) & 1;
  if ((fhd >> 3) & 1) fail();  // reserved bit
  bool checksum = (fhd >> 2) & 1;
  int did_flag = fhd & 3;
  if (!single) {
    if (i >= n) fail();
    i++;  // window descriptor: the whole output is the window here
  }
  static const int kDid[4] = {0, 1, 2, 4};
  uint64_t did = 0;
  if (i + kDid[did_flag] > n) fail();
  for (int k = 0; k < kDid[did_flag]; k++) did |= (uint64_t)in[i + k] << (8 * k);
  i += kDid[did_flag];
  if (did) fail(-4);
  int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
  int64_t content = -1;
  if (fcs_size) {
    if (i + fcs_size > n) fail();
    uint64_t v = 0;
    for (int k = 0; k < fcs_size; k++) v |= (uint64_t)in[i + k] << (8 * k);
    if (fcs_size == 2) v += 256;
    i += fcs_size;
    content = (int64_t)v;
    if (content > cap - o) fail(-3);
  }
  FrameState fs;
  const int64_t start = o;
  while (true) {
    if (i + 3 > n) fail();
    uint32_t bh = in[i] | (in[i + 1] << 8) | (in[i + 2] << 16);
    i += 3;
    bool last = bh & 1;
    int btype = (bh >> 1) & 3;
    int64_t bsize = bh >> 3;
    if (btype == 0) {
      if (i + bsize > n) fail();
      if (o + bsize > cap) fail(-3);
      memcpy(out + o, in + i, bsize);
      o += bsize;
      i += bsize;
    } else if (btype == 1) {
      if (i + 1 > n) fail();
      if (o + bsize > cap) fail(-3);
      memset(out + o, in[i], bsize);
      o += bsize;
      i += 1;
    } else if (btype == 2) {
      if (i + bsize > n || bsize > (1 << 17)) fail();
      compressed_block(fs, in + i, bsize, out, start, &o, cap);
      i += bsize;
    } else {
      fail();
    }
    if (last) break;
  }
  if (content >= 0 && o - start != content) fail();
  if (checksum) {
    if (i + 4 > n) fail();
    uint32_t want = rd32(in + i);
    i += 4;
    if ((uint32_t)xxh64(out + start, o - start) != want) fail(-2);
  }
  *used = i;
  return o;
}

}  // namespace

extern "C" {

int64_t sr_zstd_decompress(const uint8_t* in, int64_t n, uint8_t* out,
                           int64_t cap) {
  try {
    int64_t i = 0, o = 0;
    if (n == 0) fail();
    while (i < n) {
      if (i + 4 > n) fail();
      uint32_t magic = rd32(in + i);
      if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
        if (i + 8 > n) fail();
        int64_t len = rd32(in + i + 4);
        if (i + 8 + len > n) fail();
        i += 8 + len;
        continue;
      }
      if (magic != 0xFD2FB528u) fail();
      int64_t used = 0;
      o = frame(in + i, n - i, out, o, cap, &used);
      i += used;
    }
    return o;
  } catch (const Fail& f) {
    return f.code;
  } catch (...) {
    return -1;
  }
}

}  // extern "C"
