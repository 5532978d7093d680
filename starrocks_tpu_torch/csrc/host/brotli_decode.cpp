// A Brotli decoder (RFC 7932), written from the RFC: parquet's BROTLI codec
// (storage/formats/parquet.py), built on its own at first use by
// starrocks_tpu_torch/native.py.
//
// sr_brotli_decompress(in, n, out, cap) decodes the stream in[0..n) into
// out[0..cap) and returns the bytes it wrote, or a negative error: -1 a
// malformed or truncated stream, -3 more output than `cap`. It covers the
// whole format: the window size (WBITS, section 9.1); meta-block headers,
// empty, metadata and uncompressed meta-blocks included (9.2); simple and
// complex prefix codes (3.4, 3.5); block types and counts of the three
// categories with their block switches (6); NPOSTFIX/NDIRECT and the
// four-entry distance ring (4); the literal context modes and context maps
// with their run lengths and inverse move-to-front (7); insert-and-copy
// commands (5); and references into the static dictionary through the 121
// word transforms (8, Appendices A and B). The tables the RFC gives as data
// (the dictionary, the transforms, the context lookup) are in
// brotli_tables.inc, generated by tests/data/torch_formats/
// make_brotli_tables.py; the rest is written out below.

#include <cstdint>
#include <cstring>
#include <vector>

#include "brotli_tables.inc"

namespace {

// --- bits ------------------------------------------------------------------------

// LSB-first bits of in[0..n); reading past the end yields zeros and sets
// the position past 8 * n, which `ok` reports.
struct Bits {
  const uint8_t* in;
  int64_t n;
  int64_t pos = 0;  // bits consumed

  uint64_t peek(int k) const {  // k <= 56
    const int64_t at = pos >> 3;
    uint64_t w = 0;
    if (at + 8 <= n) {
      memcpy(&w, in + at, 8);
    } else {
      for (int64_t i = 0; at + i < n && i < 8; i++)
        w |= (uint64_t)in[at + i] << (8 * i);
    }
    w >>= (pos & 7);
    return k >= 64 ? w : (w & ((1ULL << k) - 1));
  }
  uint32_t take(int k) {
    if (k == 0) return 0;
    uint32_t v = (uint32_t)peek(k);
    pos += k;
    return v;
  }
  bool ok() const { return pos <= 8 * n; }
  // to the next byte boundary; the skipped bits must be zero
  bool align() {
    int r = (int)((8 - (pos & 7)) & 7);
    return take(r) == 0;
  }
};

// --- prefix codes (section 3) ------------------------------------------------------

constexpr int kRoot = 10;  // bits of the first-level lookup
constexpr int kMaxLen = 15;

// A canonical prefix code: a table of the codes of up to kRoot bits (index:
// the next kRoot bits of the stream; entry: symbol << 8 | length, or 0xFF
// for a longer code) and, for those, the symbols sorted by (length,
// symbol) with the count of each length (decoded bit by bit).
struct Code {
  std::vector<uint32_t> root;
  uint16_t count[kMaxLen + 1];
  std::vector<uint16_t> sorted;
  int single = -1;  // the one symbol of a one-symbol code (0 bits)

  bool build(const uint8_t* lens, int nsym) {
    memset(count, 0, sizeof(count));
    for (int s = 0; s < nsym; s++) count[lens[s]]++;
    count[0] = 0;
    int offs[kMaxLen + 2];
    offs[1] = 0;
    for (int l = 1; l <= kMaxLen; l++) offs[l + 1] = offs[l] + count[l];
    sorted.assign(offs[kMaxLen + 1], 0);
    for (int s = 0; s < nsym; s++)
      if (lens[s]) sorted[offs[lens[s]]++] = (uint16_t)s;
    root.assign(1u << kRoot, 0xFF);
    uint32_t code = 0;
    int k = 0;
    for (int l = 1; l <= kMaxLen; l++) {
      for (int i = 0; i < count[l]; i++, k++, code++) {
        if (l > kRoot) continue;
        uint32_t rev = 0;  // the code's bits, first-read first
        for (int b = 0; b < l; b++) rev |= ((code >> b) & 1) << (l - 1 - b);
        for (uint32_t j = rev; j < (1u << kRoot); j += 1u << l)
          root[j] = ((uint32_t)sorted[k] << 8) | (uint32_t)l;
      }
      code <<= 1;
    }
    return true;
  }

  int decode(Bits& br) const {
    if (single >= 0) return single;
    const uint32_t v = (uint32_t)br.peek(kMaxLen);
    const uint32_t e = root[v & ((1u << kRoot) - 1)];
    if ((e & 0xFF) != 0xFF) {
      br.pos += e & 0xFF;
      return (int)(e >> 8);
    }
    int code = 0, first = 0, index = 0;
    for (int l = 1; l <= kMaxLen; l++) {
      code |= (v >> (l - 1)) & 1;
      const int c = count[l];
      if (code - first < c) {
        br.pos += l;
        return sorted[index + code - first];
      }
      index += c;
      first = (first + c) << 1;
      code <<= 1;
    }
    return -1;
  }
};

int bits_for(int alphabet) {  // ALPHABET_BITS: enough bits for alphabet - 1
  int b = 0;
  while (((alphabet - 1) >> b) != 0) b++;
  return b;
}

// the code-length code's fixed prefix code (section 3.5), by the next 4
// bits of the stream: symbols 0-5 with codes 00, 0111, 011, 10, 01, 1111
// (written first-read bit last)
const uint8_t kClLen[16] = {2, 2, 2, 3, 2, 2, 2, 4, 2, 2, 2, 3, 2, 2, 2, 4};
const uint8_t kClSym[16] = {0, 4, 3, 2, 0, 4, 3, 1, 0, 4, 3, 2, 0, 4, 3, 5};
const uint8_t kClOrder[18] = {1, 2, 3, 4, 0, 5, 17, 6, 16,
                              7, 8, 9, 10, 11, 12, 13, 14, 15};

// read one prefix code over `alphabet` symbols (those from `limit` on
// must not occur)
bool read_code(Bits& br, int alphabet, int limit, Code& out) {
  std::vector<uint8_t> lens(alphabet, 0);
  out.single = -1;
  const uint32_t hskip = br.take(2);
  if (hskip == 1) {  // simple prefix code
    const int nsym = (int)br.take(2) + 1;
    const int nb = bits_for(alphabet);
    int syms[4];
    for (int i = 0; i < nsym; i++) {
      syms[i] = (int)br.take(nb);
      if (syms[i] >= limit) return false;
      for (int j = 0; j < i; j++)
        if (syms[j] == syms[i]) return false;
    }
    if (nsym == 1) {
      out.single = syms[0];
      return br.ok();
    }
    static const uint8_t kSimple[5][4] = {
        {0, 0, 0, 0}, {0, 0, 0, 0}, {1, 1, 0, 0}, {1, 2, 2, 0}, {2, 2, 2, 2}};
    const uint8_t* l = kSimple[nsym];
    if (nsym == 4 && br.take(1)) {
      static const uint8_t kTree[4] = {1, 2, 3, 3};
      l = kTree;
    }
    for (int i = 0; i < nsym; i++) lens[syms[i]] = l[i];
    return br.ok() && out.build(lens.data(), alphabet);
  }
  // complex prefix code: the code lengths of the code-length alphabet,
  // from position hskip of kClOrder
  uint8_t cl[18] = {0};
  int space = 32, ncodes = 0;
  for (int i = (int)hskip; i < 18 && space > 0; i++) {
    const uint32_t v = (uint32_t)br.peek(4);
    br.pos += kClLen[v];
    const int len = kClSym[v];
    cl[kClOrder[i]] = (uint8_t)len;
    if (len) {
      space -= 32 >> len;
      ncodes++;
    }
  }
  if (!br.ok() || !(ncodes == 1 || space == 0)) return false;
  Code clc;
  if (ncodes == 1) {
    for (int s = 0; s < 18; s++)
      if (cl[s]) clc.single = s;
  } else {
    clc.build(cl, 18);
  }
  int sym = 0, prev = 8, repeat = 0, repeat_len = 0;
  int left = 32768;
  while (sym < alphabet && left > 0) {
    const int p = clc.decode(br);
    if (p < 0 || !br.ok()) return false;
    if (p < 16) {
      repeat = 0;
      lens[sym++] = (uint8_t)p;
      if (p) {
        prev = p;
        left -= 32768 >> p;
      }
      continue;
    }
    const int extra = p == 16 ? 2 : 3;
    const int len = p == 16 ? prev : 0;
    if (repeat_len != len) {
      repeat = 0;
      repeat_len = len;
    }
    const int old = repeat;
    if (repeat > 0) repeat = (repeat - 2) << extra;
    repeat += (int)br.take(extra) + 3;
    const int delta = repeat - old;
    if (sym + delta > alphabet) return false;
    for (int i = 0; i < delta; i++) lens[sym++] = (uint8_t)repeat_len;
    if (repeat_len) left -= delta << (15 - repeat_len);
  }
  if (left != 0 || !br.ok()) return false;
  for (int s = limit; s < alphabet; s++)
    if (lens[s]) return false;
  return out.build(lens.data(), alphabet);
}

// --- the header's small integers ------------------------------------------------

int var_len_uint8(Bits& br) {  // section 9.2: 0-255
  if (!br.take(1)) return 0;
  const int nb = (int)br.take(3);
  if (nb == 0) return 1;
  return (1 << nb) + (int)br.take(nb);
}

// block count codes (section 6)
const uint32_t kCountBase[26] = {1,    5,    9,    13,   17,   25,   33,
                                 41,   49,   65,   81,   97,   113,  145,
                                 177,  209,  241,  305,  369,  497,  753,
                                 1265, 2289, 4337, 8433, 16625};
const uint8_t kCountExtra[26] = {2, 2, 2, 2, 3, 3, 3, 3, 4,  4,  4,  4,  5,
                                 5, 5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13, 24};
// insert and copy length codes (section 5)
const uint32_t kInsBase[24] = {0,   1,   2,   3,    4,    5,    6,    8,
                               10,  14,  18,  26,   34,   50,   66,   98,
                               130, 194, 322, 578, 1090, 2114, 6210, 22594};
const uint8_t kInsExtra[24] = {0, 0, 0, 0, 0, 0, 1, 1, 2, 2,  3,  3,
                               4, 4, 5, 5, 6, 7, 8, 9, 10, 12, 14, 24};
const uint32_t kCopyBase[24] = {2,   3,   4,   5,   6,   7,   8,   9,
                                10,  12,  14,  18,  22,  30,  38,  54,
                                70,  102, 134, 198, 326, 582, 1094, 2118};
const uint8_t kCopyExtra[24] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2,  2,
                                3, 3, 4, 4, 5, 5, 6, 7, 8, 9, 10, 24};
// the insert-and-copy cells (cmd >> 6): the first insert and copy length
// codes of the cell's 8 x 8 block; cells 0 and 1 use distance code 0
const uint8_t kCellIns[11] = {0, 0, 0, 0, 8, 8, 0, 16, 8, 16, 16};
const uint8_t kCellCopy[11] = {0, 8, 0, 8, 0, 8, 16, 0, 16, 8, 16};

// One category's block switching (section 6): its types, the current
// block's type and what is left of its count.
struct Blocks {
  int ntypes = 1;
  Code types, counts;
  int type = 0, prev = 1;
  uint32_t left = 1u << 24;

  bool read(Bits& br) {
    ntypes = var_len_uint8(br) + 1;
    type = 0;
    prev = 1;
    left = 1u << 24;
    if (ntypes < 2) return br.ok();
    if (!read_code(br, ntypes + 2, ntypes + 2, types)) return false;
    if (!read_code(br, 26, 26, counts)) return false;
    return count(br);
  }
  bool count(Bits& br) {
    const int c = counts.decode(br);
    if (c < 0) return false;
    left = kCountBase[c] + br.take(kCountExtra[c]);
    return br.ok();
  }
  bool next(Bits& br) {  // a block switch command
    if (ntypes < 2) return false;  // one type: its 2^24 count ran out
    const int t = types.decode(br);
    if (t < 0) return false;
    int nt = t == 0 ? prev : (t == 1 ? (type + 1) % ntypes : t - 2);
    if (nt >= ntypes) return false;
    prev = type;
    type = nt;
    return count(br);
  }
};

// a context map (section 7.3) of `size` entries over `ntrees` trees
bool read_context_map(Bits& br, int size, int ntrees,
                      std::vector<uint8_t>& map) {
  map.assign(size, 0);
  if (ntrees < 2) return br.ok();
  int rlemax = 0;
  if (br.take(1)) rlemax = (int)br.take(4) + 1;
  Code code;
  if (!read_code(br, ntrees + rlemax, ntrees + rlemax, code)) return false;
  for (int i = 0; i < size;) {
    const int z = code.decode(br);
    if (z < 0 || !br.ok()) return false;
    if (z == 0) {
      map[i++] = 0;
    } else if (z <= rlemax) {
      const int run = (1 << z) + (int)br.take(z);
      if (i + run > size) return false;
      for (int k = 0; k < run; k++) map[i++] = 0;
    } else {
      map[i++] = (uint8_t)(z - rlemax);
    }
  }
  if (br.take(1)) {  // inverse move-to-front
    uint8_t mtf[256];
    for (int i = 0; i < 256; i++) mtf[i] = (uint8_t)i;
    for (int i = 0; i < size; i++) {
      const int idx = map[i];
      const uint8_t v = mtf[idx];
      map[i] = v;
      memmove(mtf + 1, mtf, idx);
      mtf[0] = v;
    }
  }
  for (int i = 0; i < size; i++)
    if (map[i] >= ntrees) return false;
  return br.ok();
}

// --- the static dictionary (section 8) ------------------------------------------

int ferment(uint8_t* w, int len, int pos) {
  if (w[pos] < 192) {
    if (w[pos] >= 97 && w[pos] <= 122) w[pos] ^= 32;
    return 1;
  }
  if (w[pos] < 224) {
    if (pos + 1 < len) w[pos + 1] ^= 32;
    return 2;
  }
  if (pos + 2 < len) w[pos + 2] ^= 5;
  return 3;
}

// the transformed word `id` of length `len` into out (at most 24 + the
// longest prefix and suffix); its length, or -1
int dictionary_word(int len, uint32_t id, uint8_t* out) {
  if (len < 4 || len > 24) return -1;
  const int nbits = kNdBits[len];
  const uint32_t index = id & ((1u << nbits) - 1);
  const uint32_t tid = id >> nbits;
  if (tid >= sizeof(kTransforms) / sizeof(kTransforms[0])) return -1;
  uint32_t offset = 0;
  for (int l = 4; l < len; l++) offset += (uint32_t)l << kNdBits[l];
  const uint8_t* word = kDictionary + offset + index * (uint32_t)len;
  const BrotliTransform& t = kTransforms[tid];
  int o = 0;
  memcpy(out, t.prefix, t.prefix_len);
  o += t.prefix_len;
  int skip = 0, wlen = len;
  if (t.type >= 1 && t.type <= 9) wlen = len > t.type ? len - t.type : 0;
  if (t.type >= 12 && t.type <= 20) {
    skip = t.type - 11;
    if (skip > len) skip = len;
    wlen = len - skip;
  }
  uint8_t* w = out + o;
  memcpy(w, word + skip, wlen);
  if (t.type == 10 && wlen > 0) {
    ferment(w, wlen, 0);
  } else if (t.type == 11) {
    for (int p = 0; p < wlen;) p += ferment(w, wlen, p);
  }
  o += wlen;
  memcpy(out + o, t.suffix, t.suffix_len);
  return o + t.suffix_len;
}

// --- meta-blocks -----------------------------------------------------------------

struct Decoder {
  Bits br;
  uint8_t* out;
  int64_t cap;
  int64_t o = 0;
  int64_t window = 0;
  int32_t ring[4] = {16, 15, 11, 4};  // ring[3] is the last distance
  int err = 0;

  int32_t last(int k) const { return ring[3 - k]; }  // k = 0 the last
  void push(int32_t d) {
    ring[0] = ring[1];
    ring[1] = ring[2];
    ring[2] = ring[3];
    ring[3] = d;
  }

  bool emit(uint8_t b) {
    if (o >= cap) {
      err = -3;
      return false;
    }
    out[o++] = b;
    return true;
  }

  bool compressed(int64_t mlen) {
    Blocks cat[3];  // literals, insert-and-copy, distances
    for (auto& c : cat)
      if (!c.read(br)) return false;
    const int npostfix = (int)br.take(2);
    const int ndirect = (int)br.take(4) << npostfix;
    std::vector<uint8_t> modes(cat[0].ntypes);
    for (auto& m : modes) m = (uint8_t)br.take(2);
    const int ntreesl = var_len_uint8(br) + 1;
    std::vector<uint8_t> cmapl, cmapd;
    if (!read_context_map(br, 64 * cat[0].ntypes, ntreesl, cmapl))
      return false;
    const int ntreesd = var_len_uint8(br) + 1;
    if (!read_context_map(br, 4 * cat[2].ntypes, ntreesd, cmapd))
      return false;
    std::vector<Code> lit(ntreesl), cmd(cat[1].ntypes), dist(ntreesd);
    for (auto& c : lit)
      if (!read_code(br, 256, 256, c)) return false;
    for (auto& c : cmd)
      if (!read_code(br, 704, 704, c)) return false;
    const int dalpha = 16 + ndirect + (48 << npostfix);
    for (auto& c : dist)
      if (!read_code(br, dalpha, dalpha, c)) return false;
    const int64_t end = o + mlen;
    if (end > cap) {
      err = -3;
      return false;
    }
    const uint32_t pmask = (1u << npostfix) - 1;
    uint8_t word[64];
    while (o < end) {
      if (cat[1].left == 0 && !cat[1].next(br)) return false;
      cat[1].left--;
      const int c = cmd[cat[1].type].decode(br);
      if (c < 0) return false;
      const int cell = c >> 6;
      const int ic = kCellIns[cell] + ((c >> 3) & 7);
      const int cc = kCellCopy[cell] + (c & 7);
      const int64_t ilen = kInsBase[ic] + br.take(kInsExtra[ic]);
      const int64_t clen = kCopyBase[cc] + br.take(kCopyExtra[cc]);
      if (!br.ok()) return false;
      for (int64_t i = 0; i < ilen; i++) {
        if (o >= end) return false;  // more literals than MLEN
        if (cat[0].left == 0 && !cat[0].next(br)) return false;
        cat[0].left--;
        const uint8_t p1 = o > 0 ? out[o - 1] : 0;
        const uint8_t p2 = o > 1 ? out[o - 2] : 0;
        const uint8_t* lut = kContextLookup + (modes[cat[0].type] << 9);
        const int ctx = lut[p1] | lut[256 + p2];
        const int t = cmapl[64 * cat[0].type + ctx];
        const int b = lit[t].decode(br);
        if (b < 0) return false;
        out[o++] = (uint8_t)b;
      }
      if (!br.ok()) return false;
      if (o >= end) break;  // the last command's copy part is unused
      int32_t d;
      bool pushed = true;
      if (cell < 2) {  // implicit distance code 0
        d = last(0);
        pushed = false;
      } else {
        if (cat[2].left == 0 && !cat[2].next(br)) return false;
        cat[2].left--;
        const int cid = clen > 4 ? 3 : (int)clen - 2;
        const int dc = dist[cmapd[4 * cat[2].type + cid]].decode(br);
        if (dc < 0) return false;
        if (dc < 16) {
          static const int8_t kWhich[16] = {0, 1, 2, 3, 0, 0, 0, 0,
                                            0, 0, 1, 1, 1, 1, 1, 1};
          static const int8_t kDelta[16] = {0, 0, 0, 0, -1, 1, -2, 2,
                                            -3, 3, -1, 1, -2, 2, -3, 3};
          d = last(kWhich[dc]) + kDelta[dc];
          if (d <= 0) return false;
          pushed = dc != 0;
        } else if (dc < 16 + ndirect) {
          d = dc - 15;
        } else {
          const int x = dc - ndirect - 16;
          const int nbits = 1 + (x >> (npostfix + 1));
          const int hcode = x >> npostfix;
          const int lcode = x & (int)pmask;
          const int64_t offset = ((2 + (hcode & 1)) << nbits) - 4;
          const int64_t dd = ((offset + br.take(nbits)) << npostfix) +
                             lcode + ndirect + 1;
          if (dd > (1LL << 30)) return false;
          d = (int32_t)dd;
        }
      }
      if (!br.ok()) return false;
      const int64_t maxd = o < window ? o : window;
      if (d > maxd) {  // a static dictionary reference
        const int64_t id = d - maxd - 1;
        if (id > 0x7fffffff) return false;
        const int n = dictionary_word((int)clen, (uint32_t)id, word);
        if (n < 0) return false;
        if (o + n > end) return false;
        memcpy(out + o, word, n);
        o += n;
        continue;  // not pushed onto the ring
      }
      if (o + clen > end) return false;
      const uint8_t* src = out + o - d;
      for (int64_t i = 0; i < clen; i++) out[o + i] = src[i];
      o += clen;
      if (pushed) push(d);
    }
    return o == end && br.ok();
  }

  int64_t run() {
    // WBITS (section 9.1)
    int wbits = 16;
    if (br.take(1)) {
      const int n = (int)br.take(3);
      if (n) {
        wbits = 17 + n;
      } else {
        const int m = (int)br.take(3);
        if (m == 1) return -1;  // large windows are not RFC 7932's
        wbits = m ? 8 + m : 17;
      }
    }
    window = (1LL << wbits) - 16;
    for (;;) {
      const bool islast = br.take(1);
      if (islast && br.take(1)) break;  // ISLASTEMPTY
      const int mn = (int)br.take(2);
      if (mn == 3) {  // metadata
        if (br.take(1)) return -1;
        const int nbytes = (int)br.take(2);
        int64_t skip = 0;
        for (int i = 0; i < nbytes; i++) {
          const int64_t b = br.take(8);
          if (i == nbytes - 1 && nbytes > 1 && b == 0) return -1;
          skip |= b << (8 * i);
        }
        if (nbytes) skip += 1;
        if (!br.align()) return -1;
        br.pos += 8 * skip;
        if (!br.ok()) return -1;
        if (islast) break;
        continue;
      }
      const int nibbles = mn + 4;
      int64_t mlen = 0;
      for (int i = 0; i < nibbles; i++) {
        const int64_t v = br.take(4);
        if (i == nibbles - 1 && nibbles > 4 && v == 0) return -1;
        mlen |= v << (4 * i);
      }
      mlen += 1;
      if (!islast && br.take(1)) {  // ISUNCOMPRESSED
        if (!br.align()) return -1;
        const int64_t at = br.pos >> 3;
        if (at + mlen > br.n) return -1;
        if (o + mlen > cap) return -3;
        memcpy(out + o, br.in + at, mlen);
        o += mlen;
        br.pos += 8 * mlen;
        continue;
      }
      if (!br.ok()) return -1;
      if (!compressed(mlen)) return err ? err : -1;
      if (islast) break;
    }
    return br.ok() ? o : -1;
  }
};

}  // namespace

extern "C" {

int64_t sr_brotli_decompress(const uint8_t* in, int64_t n, uint8_t* out,
                             int64_t cap) {
  Decoder dec;
  dec.br.in = in;
  dec.br.n = n;
  dec.out = out;
  dec.cap = cap;
  return dec.run();
}

}  // extern "C"
