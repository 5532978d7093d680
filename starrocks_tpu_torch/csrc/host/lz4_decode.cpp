// An LZ4 block decoder (the LZ4 block format description), for the port's
// parquet (codecs LZ4_RAW and LZ4) and ORC (codec LZ4) readers; built on its
// own at first use by starrocks_tpu_torch/native.py (`lz4_decompress`). The
// containers (Hadoop framing, ORC chunk headers) are parsed in Python.
//
// sr_lz4_block_decompress(in, n, out, cap): one raw block of `n` bytes into
//   `out`. Returns the bytes written, or -1 when the block is malformed or
//   truncated, or would write more than `cap` bytes.
//
// A block is a run of sequences: a token (literal length in the high nibble,
// match length - 4 in the low one, 15 meaning more length bytes follow, each
// added until one is below 255), the literals, a 2-byte little-endian offset
// and the match. The last sequence holds literals only: the block ends right
// after them. A match may overlap its own output (offset < length).

#include <cstdint>
#include <cstring>

extern "C" {

int64_t sr_lz4_block_decompress(const uint8_t* in, int64_t n, uint8_t* out,
                                int64_t cap) {
  int64_t i = 0, o = 0;
  if (n <= 0) return -1;
  while (true) {
    if (i >= n) return -1;
    const uint8_t token = in[i++];
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (i >= n) return -1;
        b = in[i++];
        lit += b;
      } while (b == 255);
    }
    if (i + lit > n || o + lit > cap) return -1;
    memcpy(out + o, in + i, (size_t)lit);
    i += lit;
    o += lit;
    if (i == n) return o;  // the last sequence: literals only
    if (i + 2 > n) return -1;
    const int64_t off = (int64_t)in[i] | ((int64_t)in[i + 1] << 8);
    i += 2;
    if (off == 0 || off > o) return -1;
    int64_t len = token & 15;
    if (len == 15) {
      uint8_t b;
      do {
        if (i >= n) return -1;
        b = in[i++];
        len += b;
      } while (b == 255);
    }
    len += 4;
    if (o + len > cap) return -1;
    uint8_t* d = out + o;
    const uint8_t* s = d - off;
    if (off >= len) {
      memcpy(d, s, (size_t)len);
    } else {
      for (int64_t k = 0; k < len; k++) d[k] = s[k];  // overlaps itself
    }
    o += len;
  }
}

}  // extern "C"
