// The CSV lane of Session.load_csv and the string dictionaries of the
// loaders (runtime/session.py, storage/formats/), built on its own at first
// use by starrocks_tpu_torch/native.py.
//
// sr_csv_count_rows, sr_csv_parse: copies of the JAX package's
// native/sr_native.cpp functions. One pass over an unquoted file into
// typed buffers: 0 = int64, 1 = float64, 2 = date (YYYY-MM-DD -> days
// since 1970-01-01), 3 = string ((start, end) byte offsets into the file,
// two int64 per row). An empty field is NULL.
//
// sr_csv_parse_quoted: the port's own lane for what the reference hands to
// pyarrow's CSV reader (quoted files and reader options). RFC 4180
// quoting: a field that opens with '"' runs to the matching '"', and '""'
// inside it is one '"'; the parser unescapes such a field in place (the
// buffer is the caller's copy), so its offsets stay one contiguous range.
// CRLF line ends and empty lines are accepted. NULLs follow pyarrow's
// defaults: a string field is never NULL; any other field is NULL when it
// is empty or one of pyarrow's null spellings ("NULL", "NaN", "N/A", ...).
// Two more types: 4 = boolean (true/false/1/0 into int64), 5 = datetime
// (YYYY-MM-DD[ HH:MM:SS[.ffffff]] -> microseconds since the epoch).
//
// sr_dict_encode: the StringDict of a string column in bulk. Strings are
// deduplicated through a hash table, the distinct ones sorted by their
// bytes (UTF-8 byte order is code point order, the order of numpy's
// unique over str), and every row gets the rank of its string: the
// dictionary and codes StringDict.from_strings makes, without one Python
// object per row. sr_gather_fixed copies chosen strings into a fixed-width
// buffer (numpy's 'S<w>' layout) for the values' bulk decode.
//
// sr_csv_format: the writer the loaders' tests and chip_smoke.py use to
// make CSV files of a table: int64, float64 (%.17g), date, scaled decimal
// and dictionary-coded string columns; a NULL is an empty field, and a
// string that is empty or holds the delimiter, a quote or a line break is
// quoted (so an empty string and a NULL stay apart).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <strings.h>
#include <thread>
#include <vector>

extern "C" {

int64_t sr_csv_count_rows(const char* buf, int64_t len) {
  int64_t rows = 0;
  for (int64_t i = 0; i < len; i++)
    if (buf[i] == '\n') rows++;
  if (len > 0 && buf[len - 1] != '\n') rows++;
  return rows;
}

static inline int64_t days_from_civil(int64_t y, int64_t m, int64_t d) {
  y -= m <= 2;
  int64_t era = (y >= 0 ? y : y - 399) / 400;
  int64_t yoe = y - era * 400;
  int64_t doy = (153 * (m > 2 ? m - 3 : m + 9) + 2) / 5 + d - 1;
  int64_t doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return era * 146097 + doe - 719468;
}

// returns number of parsed rows; -1 on structural error (bad digit, short
// date, too many fields in a line, or more rows than max_rows buffers hold).
int64_t sr_csv_parse(const char* buf, int64_t len, char delim, int32_t ncols,
                     const int32_t* types, void** out_cols,
                     uint8_t** null_masks, int64_t max_rows) {
  int64_t row = 0;
  int64_t i = 0;
  while (i < len) {
    if (row >= max_rows) return -1;
    for (int32_t c = 0; c < ncols; c++) {
      int64_t start = i;
      while (i < len && buf[i] != delim && buf[i] != '\n') i++;
      int64_t end = i;
      bool is_null = (end == start);
      if (null_masks && null_masks[c]) null_masks[c][row] = is_null ? 0 : 1;
      switch (types[c]) {
        case 0: {  // int64
          int64_t v = 0;
          bool neg = false;
          int64_t p = start;
          if (p < end && (buf[p] == '-' || buf[p] == '+')) {
            neg = buf[p] == '-';
            p++;
          }
          for (; p < end; p++) {
            char ch = buf[p];
            if (ch < '0' || ch > '9') return -1;
            v = v * 10 + (ch - '0');
          }
          ((int64_t*)out_cols[c])[row] = neg ? -v : v;
          break;
        }
        case 1: {  // float64
          if (is_null) {
            ((double*)out_cols[c])[row] = 0.0;
          } else {
            char tmp[64];
            int64_t m = end - start;
            if (m > 63) m = 63;
            memcpy(tmp, buf + start, m);
            tmp[m] = 0;
            ((double*)out_cols[c])[row] = strtod(tmp, nullptr);
          }
          break;
        }
        case 2: {  // date YYYY-MM-DD
          if (is_null || end - start < 10) {
            ((int64_t*)out_cols[c])[row] = 0;
            if (!is_null && end - start < 10) return -1;
          } else {
            const char* s = buf + start;
            int64_t y = (s[0] - '0') * 1000 + (s[1] - '0') * 100 +
                        (s[2] - '0') * 10 + (s[3] - '0');
            int64_t mo = (s[5] - '0') * 10 + (s[6] - '0');
            int64_t d = (s[8] - '0') * 10 + (s[9] - '0');
            ((int64_t*)out_cols[c])[row] = days_from_civil(y, mo, d);
          }
          break;
        }
        case 3: {  // string: record (start, end) offsets
          ((int64_t*)out_cols[c])[row * 2] = start;
          ((int64_t*)out_cols[c])[row * 2 + 1] = end;
          break;
        }
        default:
          return -1;
      }
      if (c + 1 < ncols) {
        if (i >= len || buf[i] != delim) return -1;  // too few fields
        i++;
      }
    }
    if (i < len && buf[i] != '\n') return -1;  // too many fields in this line
    if (i < len) i++;
    row++;
  }
  return row;
}

// --- the quoted lane ---------------------------------------------------------

static const char* const kNullTokens[] = {
    "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "N/A", "NA", "NULL", "NaN", "n/a", "nan", "null"};

static bool is_null_token(const char* s, int64_t m) {
  if (m == 0) return true;
  for (const char* t : kNullTokens) {
    int64_t k = (int64_t)strlen(t);
    if (k == m && memcmp(s, t, m) == 0) return true;
  }
  return false;
}

static bool digits(const char* s, int64_t n, int64_t* out) {
  int64_t v = 0;
  for (int64_t k = 0; k < n; k++) {
    if (s[k] < '0' || s[k] > '9') return false;
    v = v * 10 + (s[k] - '0');
  }
  *out = v;
  return true;
}

static bool parse_date(const char* s, int64_t m, int64_t* days) {
  int64_t y, mo, d;
  if (m != 10 || s[4] != '-' || s[7] != '-') return false;
  if (!digits(s, 4, &y) || !digits(s + 5, 2, &mo) || !digits(s + 8, 2, &d))
    return false;
  if (mo < 1 || mo > 12 || d < 1 || d > 31) return false;
  *days = days_from_civil(y, mo, d);
  return true;
}

static bool parse_value(int32_t type, const char* s, int64_t m, void* col,
                        int64_t row) {
  switch (type) {
    case 0: {
      int64_t p = 0, v = 0;
      bool neg = false;
      if (p < m && (s[p] == '-' || s[p] == '+')) {
        neg = s[p] == '-';
        p++;
      }
      if (p == m || !digits(s + p, m - p, &v)) return false;
      ((int64_t*)col)[row] = neg ? -v : v;
      return true;
    }
    case 1: {
      char tmp[128];
      if (m > 127) return false;
      memcpy(tmp, s, m);
      tmp[m] = 0;
      char* endp = nullptr;
      double v = strtod(tmp, &endp);
      if (endp != tmp + m) return false;
      ((double*)col)[row] = v;
      return true;
    }
    case 2: {
      int64_t days;
      if (!parse_date(s, m, &days)) return false;
      ((int64_t*)col)[row] = days;
      return true;
    }
    case 4: {
      int64_t v;
      if (m == 1 && (s[0] == '0' || s[0] == '1')) {
        v = s[0] - '0';
      } else if (m == 4 && strncasecmp(s, "true", 4) == 0) {
        v = 1;
      } else if (m == 5 && strncasecmp(s, "false", 5) == 0) {
        v = 0;
      } else {
        return false;
      }
      ((int64_t*)col)[row] = v;
      return true;
    }
    case 5: {
      int64_t days, h = 0, mi = 0, sec = 0, frac = 0;
      if (m < 10 || !parse_date(s, 10, &days)) return false;
      if (m > 10) {
        if (m < 19 || (s[10] != ' ' && s[10] != 'T') || s[13] != ':' ||
            s[16] != ':')
          return false;
        if (!digits(s + 11, 2, &h) || !digits(s + 14, 2, &mi) ||
            !digits(s + 17, 2, &sec))
          return false;
        if (m > 19) {
          int64_t nf = m - 20;
          if (s[19] != '.' || nf < 1 || nf > 6 || !digits(s + 20, nf, &frac))
            return false;
          for (int64_t k = nf; k < 6; k++) frac *= 10;
        }
      }
      ((int64_t*)col)[row] =
          ((days * 24 + h) * 60 + mi) * 60 * 1000000 + sec * 1000000 + frac;
      return true;
    }
    default:
      return false;
  }
}

// returns the rows parsed, or -1 with *err_row set to the row at fault.
int64_t sr_csv_parse_quoted(char* buf, int64_t len, char delim, int32_t ncols,
                            const int32_t* types, void** out_cols,
                            uint8_t** null_masks, int64_t max_rows,
                            int64_t* err_row) {
  int64_t row = 0;
  int64_t i = 0;
  while (i < len) {
    // empty lines are skipped, as pyarrow's reader does
    if (buf[i] == '\n') {
      i++;
      continue;
    }
    if (buf[i] == '\r' && i + 1 < len && buf[i + 1] == '\n') {
      i += 2;
      continue;
    }
    *err_row = row;
    if (row >= max_rows) return -1;
    for (int32_t c = 0; c < ncols; c++) {
      int64_t start, end;
      if (i < len && buf[i] == '"') {
        i++;
        start = i;
        int64_t w = i;
        for (;;) {
          if (i >= len) return -1;  // unterminated quote
          if (buf[i] == '"') {
            if (i + 1 < len && buf[i + 1] == '"') {
              buf[w++] = '"';
              i += 2;
              continue;
            }
            i++;
            break;
          }
          buf[w++] = buf[i++];
        }
        end = w;
        if (i < len && buf[i] == '\r' && (i + 1 == len || buf[i + 1] == '\n'))
          i++;
      } else {
        start = i;
        while (i < len && buf[i] != delim && buf[i] != '\n') i++;
        end = i;
        if (end > start && buf[end - 1] == '\r' && (i == len || buf[i] == '\n'))
          end--;
      }
      const char* s = buf + start;
      int64_t m = end - start;
      int32_t t = types[c];
      bool is_null = t != 3 && is_null_token(s, m);
      null_masks[c][row] = is_null ? 0 : 1;
      if (t == 3) {
        ((int64_t*)out_cols[c])[row * 2] = start;
        ((int64_t*)out_cols[c])[row * 2 + 1] = end;
      } else if (is_null) {
        if (t == 1)
          ((double*)out_cols[c])[row] = 0.0;
        else
          ((int64_t*)out_cols[c])[row] = 0;
      } else if (!parse_value(t, s, m, out_cols[c], row)) {
        return -1;
      }
      if (c + 1 < ncols) {
        if (i >= len || buf[i] != delim) return -1;  // too few fields
        i++;
      }
    }
    if (i < len && buf[i] != '\n') return -1;  // too many fields
    if (i < len) i++;
    row++;
  }
  return row;
}

// --- string dictionaries -----------------------------------------------------

static inline uint64_t hash_bytes(const char* s, int64_t n) {
  uint64_t h = 1469598103934665603ULL ^ (uint64_t)n;
  int64_t k = 0;
  for (; k + 8 <= n; k += 8) {
    uint64_t w;
    memcpy(&w, s + k, 8);
    h = (h ^ w) * 0x100000001B3ULL;
    h ^= h >> 29;
  }
  for (; k < n; k++) h = (h ^ (uint8_t)s[k]) * 0x100000001B3ULL;
  h ^= h >> 32;
  return h * 0x9E3779B97F4A7C15ULL;
}

static inline int cmp_bytes(const char* a, int64_t na, const char* b,
                            int64_t nb) {
  int r = memcmp(a, b, (size_t)std::min(na, nb));
  if (r != 0) return r;
  return na < nb ? -1 : (na > nb ? 1 : 0);
}

// offs: 2 int64 per row, (start, end) into buf. codes[i] receives the rank
// of row i's string among the distinct strings; first_row[r] a row whose
// string has rank r. Returns the number of distinct strings.
int64_t sr_dict_encode(const char* buf, const int64_t* offs, int64_t n,
                       int32_t* codes, int64_t* first_row, int32_t nthreads) {
  if (n == 0) return 0;
  uint64_t cap = 16;
  while (cap < (uint64_t)n * 2) cap <<= 1;
  std::vector<int64_t> slot(cap, -1);  // first row of the string, or -1
  std::vector<int32_t> uid(n);
  std::vector<int64_t> reps;  // first row of each distinct string
  const uint64_t mask = cap - 1;
  for (int64_t i = 0; i < n; i++) {
    const char* s = buf + offs[2 * i];
    int64_t m = offs[2 * i + 1] - offs[2 * i];
    uint64_t h = hash_bytes(s, m) & mask;
    for (;;) {
      int64_t r = slot[h];
      if (r < 0) {
        slot[h] = (int64_t)reps.size();
        uid[i] = (int32_t)reps.size();
        reps.push_back(i);
        break;
      }
      int64_t j = reps[r];
      const char* t = buf + offs[2 * j];
      int64_t mt = offs[2 * j + 1] - offs[2 * j];
      if (mt == m && memcmp(s, t, m) == 0) {
        uid[i] = (int32_t)r;
        break;
      }
      h = (h + 1) & mask;
    }
  }
  std::vector<int64_t>().swap(slot);
  int64_t k = (int64_t)reps.size();
  std::vector<int32_t> order(k);
  for (int64_t u = 0; u < k; u++) order[u] = (int32_t)u;
  auto less = [&](int32_t a, int32_t b) {
    int64_t ra = reps[a], rb = reps[b];
    return cmp_bytes(buf + offs[2 * ra], offs[2 * ra + 1] - offs[2 * ra],
                     buf + offs[2 * rb], offs[2 * rb + 1] - offs[2 * rb]) < 0;
  };
  // parallel merge sort: sorted runs per thread, then pairwise merges
  if (nthreads < 1) nthreads = 1;
  int64_t parts = (k < (1 << 16)) ? 1 : nthreads;
  std::vector<int64_t> bounds;
  for (int64_t p = 0; p <= parts; p++) bounds.push_back(k * p / parts);
  {
    std::vector<std::thread> ts;
    for (int64_t p = 0; p < parts; p++)
      ts.emplace_back([&, p] {
        std::sort(order.begin() + bounds[p], order.begin() + bounds[p + 1],
                  less);
      });
    for (auto& t : ts) t.join();
  }
  while (bounds.size() > 2) {
    std::vector<int64_t> nb;
    std::vector<std::thread> ts;
    for (size_t p = 0; p + 2 < bounds.size(); p += 2) {
      int64_t lo = bounds[p], mid = bounds[p + 1], hi = bounds[p + 2];
      ts.emplace_back([&, lo, mid, hi] {
        std::inplace_merge(order.begin() + lo, order.begin() + mid,
                           order.begin() + hi, less);
      });
      nb.push_back(lo);
    }
    if (bounds.size() % 2 == 0) nb.push_back(bounds[bounds.size() - 2]);
    nb.push_back(bounds.back());
    for (auto& t : ts) t.join();
    bounds.swap(nb);
  }
  std::vector<int32_t> rank(k);
  for (int64_t r = 0; r < k; r++) {
    rank[order[r]] = (int32_t)r;
    first_row[r] = reps[order[r]];
  }
  for (int64_t i = 0; i < n; i++) codes[i] = rank[uid[i]];
  return k;
}

// out[j * width ..] = the string of row rows[j], zero-padded to width.
void sr_gather_fixed(const char* buf, const int64_t* offs, const int64_t* rows,
                     int64_t k, int64_t width, char* out) {
  for (int64_t j = 0; j < k; j++) {
    int64_t r = rows[j];
    int64_t m = offs[2 * r + 1] - offs[2 * r];
    memcpy(out + j * width, buf + offs[2 * r], (size_t)m);
    memset(out + j * width + m, 0, (size_t)(width - m));
  }
}

// --- the writer --------------------------------------------------------------

static inline char* put_i64(char* o, int64_t v) {
  char tmp[24];
  int n = 0;
  uint64_t u = v < 0 ? (uint64_t)0 - (uint64_t)v : (uint64_t)v;
  do {
    tmp[n++] = (char)('0' + u % 10);
    u /= 10;
  } while (u);
  if (v < 0) *o++ = '-';
  while (n) *o++ = tmp[--n];
  return o;
}

static inline void civil_from_days(int64_t z, int64_t* y, int64_t* m,
                                   int64_t* d) {
  z += 719468;
  int64_t era = (z >= 0 ? z : z - 146096) / 146097;
  int64_t doe = z - era * 146097;
  int64_t yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
  int64_t yy = yoe + era * 400;
  int64_t doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
  int64_t mp = (5 * doy + 2) / 153;
  *d = doy - (153 * mp + 2) / 5 + 1;
  *m = mp < 10 ? mp + 3 : mp - 9;
  *y = yy + (*m <= 2);
}

// types: 0 int64, 1 float64, 2 date (int32 days), 3 string (int32 codes
// into the dictionary dict_bufs[c] / dict_offs[c], k + 1 offsets),
// 6 decimal (int64 scaled by 10^scales[c]). valid[c] may be null (no
// NULLs). Rows [lo, hi). Returns the bytes written, or -1 when out_cap
// would be exceeded.
int64_t sr_csv_format(int32_t ncols, const int32_t* types,
                      const void* const* cols, const uint8_t* const* valid,
                      const int32_t* scales, const char* const* dict_bufs,
                      const int64_t* const* dict_offs, int64_t lo, int64_t hi,
                      char delim, char* out, int64_t out_cap) {
  char* o = out;
  char* const limit = out + out_cap;
  for (int64_t r = lo; r < hi; r++) {
    for (int32_t c = 0; c < ncols; c++) {
      if (limit - o < 64) return -1;
      if (c) *o++ = delim;
      if (valid[c] && !valid[c][r]) continue;
      switch (types[c]) {
        case 0:
          o = put_i64(o, ((const int64_t*)cols[c])[r]);
          break;
        case 1:
          o += snprintf(o, 32, "%.17g", ((const double*)cols[c])[r]);
          break;
        case 2: {
          int64_t y, m, d;
          civil_from_days(((const int32_t*)cols[c])[r], &y, &m, &d);
          o += snprintf(o, 24, "%04lld-%02lld-%02lld", (long long)y,
                        (long long)m, (long long)d);
          break;
        }
        case 6: {
          int64_t v = ((const int64_t*)cols[c])[r];
          int32_t sc = scales[c];
          if (sc == 0) {
            o = put_i64(o, v);
            break;
          }
          int64_t p = 1;
          for (int32_t k = 0; k < sc; k++) p *= 10;
          uint64_t u = v < 0 ? (uint64_t)0 - (uint64_t)v : (uint64_t)v;
          if (v < 0) *o++ = '-';
          o = put_i64(o, (int64_t)(u / (uint64_t)p));
          *o++ = '.';
          uint64_t f = u % (uint64_t)p;
          for (int32_t k = sc - 1; k >= 0; k--) {
            o[k] = (char)('0' + f % 10);
            f /= 10;
          }
          o += sc;
          break;
        }
        case 3: {
          int32_t code = ((const int32_t*)cols[c])[r];
          const char* s = dict_bufs[c] + dict_offs[c][code];
          int64_t m = dict_offs[c][code + 1] - dict_offs[c][code];
          bool quote = m == 0;
          for (int64_t k = 0; k < m && !quote; k++)
            quote = s[k] == delim || s[k] == '"' || s[k] == '\n' ||
                    s[k] == '\r';
          if (limit - o < 2 * m + 8) return -1;
          if (!quote) {
            memcpy(o, s, (size_t)m);
            o += m;
          } else {
            *o++ = '"';
            for (int64_t k = 0; k < m; k++) {
              if (s[k] == '"') *o++ = '"';
              *o++ = s[k];
            }
            *o++ = '"';
          }
          break;
        }
        default:
          return -1;
      }
    }
    *o++ = '\n';
  }
  return o - out;
}

}  // extern "C"
