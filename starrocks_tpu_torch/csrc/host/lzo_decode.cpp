// An LZO1X decoder for the port's ORC reader (codec LZO); built on its own
// at first use by starrocks_tpu_torch/native.py (`lzo_decompress`). The
// container (ORC's 3-byte chunk headers) is parsed in Python.
//
// sr_lzo1x_decompress(src, n, dst, cap): the `n` bytes at `src` into
//   `dst`. Returns the bytes written, or a negative code: -1 a malformed
//   instruction, -2 an instruction that reads past `n`, -3 output past
//   `cap`, -4 a match distance before the start of the output, -5 no end
//   marker. Every read is checked against `n`, every write against `cap`
//   and every distance against the bytes written so far.
//
// It accepts what the ORC library's lzoDecompress accepts (the decoder
// pyarrow reads ORC files with), which departs from the format's
// description (the Linux kernel's Documentation/staging/lzo.rst) in five
// places:
// - the two M1 forms are the other way round: after an instruction that
//   copied 1-3 literals, 0000DDSS HHHHHHHH copies 3 bytes from
//   (H << 2) + D + 2049 back; after one that copied 4 or more, 2 bytes
//   from (H << 2) + D + 1 back;
// - the byte 0x11 is the end marker wherever an instruction starts, and
//   the two bytes after it are skipped whatever they hold;
// - any other M4 at distance 16384 is a match, not the end of the stream;
// - after an end marker, the bytes left start another block, whose
//   matches may reach into the output of the blocks before it;
// - no input at all decodes to nothing.
// The end marker's two bytes must be there (the ORC library reads them
// past the input's end when they are not).
//
// Instructions (the state is the count of literals the last one copied):
//   first byte 18..255   literals: byte - 17 of them
//   0000LLLL, state 0    literals: L + 3, or with L = 0, 18 + the zero
//                        bytes that follow x 255 + the non-zero byte
//   0000DDSS HHHHHHHH    M1 (as above)
//   0001HMMM ... EE EE   M4: length M + 2 (M = 0: 9 + the zero-byte
//                        extension), distance 16384 + 16384 H +
//                        (EE EE >> 2), little-endian
//   001MMMMM ... EE EE   M3: length M + 2 (M = 0: 33 + the extension),
//                        distance 1 + (EE EE >> 2)
//   MMMDDDSS HHHHHHHH    M2 (first byte 64 and up): length M + 1,
//                        distance (H << 3) + D + 1
// A match's SS bits (the low bits of EE EE for M3 and M4) are the
// literals that follow it. A match may overlap its own output.

#include <cstdint>
#include <cstring>

namespace {

constexpr int64_t kMalformed = -1, kOverrun = -2, kOutput = -3,
                  kDistance = -4, kNoEnd = -5;

// The zero-byte extension of a length field: `base` plus 255 per zero
// byte plus the first non-zero one. False when the input ends first.
bool extension(const uint8_t* in, int64_t n, int64_t& i, int64_t base,
               int64_t& len) {
  len = base;
  while (true) {
    if (i >= n) return false;
    const uint8_t b = in[i++];
    if (b != 0) {
      len += b;
      return true;
    }
    len += 255;
  }
}

}  // namespace

extern "C" {

int64_t sr_lzo1x_decompress(const uint8_t* in, int64_t n, uint8_t* out,
                            int64_t cap) {
  int64_t i = 0, o = 0;
  while (i < n) {  // one block after another
    bool first = true;
    int64_t last = 0;  // literals the last instruction copied
    while (true) {
      if (i >= n) return kNoEnd;
      const uint32_t c = in[i++];
      if (c == 0x11) break;
      int64_t len = 0, dist = 0, lit;
      if (c < 16) {
        if (last == 0) {  // a literal run
          if (c == 0) {
            if (!extension(in, n, i, 15, lit)) return kOverrun;
          } else {
            lit = c;
          }
          lit += 3;
        } else {  // M1
          if (i >= n) return kOverrun;
          dist = (c >> 2) + ((int64_t)in[i++] << 2);
          if (last <= 3) {
            len = 3;
            dist += 2049;
          } else {
            len = 2;
            dist += 1;
          }
          lit = c & 3;
        }
      } else if (first) {
        if (c == 16) return kMalformed;
        lit = c - 17;
      } else if (c < 64) {  // M4 (c < 32) or M3
        const bool m4 = c < 32;
        const int64_t bits = m4 ? 7 : 31;
        len = c & bits;
        if (len == 0 && !extension(in, n, i, bits, len)) return kOverrun;
        len += 2;
        if (i + 2 > n) return kOverrun;
        const int64_t e = (int64_t)in[i] | ((int64_t)in[i + 1] << 8);
        i += 2;
        dist = (e >> 2) + (m4 ? ((c & 8) ? 0x8000 : 0x4000) : 1);
        lit = e & 3;
      } else {  // M2
        if (i >= n) return kOverrun;
        len = (c >> 5) + 1;
        dist = ((c >> 2) & 7) + ((int64_t)in[i++] << 3) + 1;
        lit = c & 3;
      }
      first = false;
      if (len) {
        if (dist > o) return kDistance;
        if (len > cap - o) return kOutput;
        uint8_t* d = out + o;
        const uint8_t* s = d - dist;
        if (dist >= len) {
          memcpy(d, s, (size_t)len);
        } else {
          for (int64_t k = 0; k < len; k++) d[k] = s[k];  // overlaps itself
        }
        o += len;
      }
      if (lit > n - i) return kOverrun;
      if (lit > cap - o) return kOutput;
      memcpy(out + o, in + i, (size_t)lit);
      i += lit;
      o += lit;
      last = lit;
    }
    if (i + 2 > n) return kNoEnd;  // the end marker's two bytes
    i += 2;
  }
  return o;
}

}  // extern "C"
