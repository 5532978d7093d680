// Fused filter + sum scan-aggregation over int64 host columns: the host lane
// behind `SET segment_strategy = 'native'` (runtime/executor.py
// _try_native_scan_agg). A copy of the JAX package's
// native/sr_native.cpp sr_fused_filter_sum_i64_mt, built on its own at
// first use by starrocks_tpu_torch/native.py.
//
// One pass over int64 columns: a conjunctive compare predicate (each term is
// column <op> literal) gates rows whose a[i]*b[i] (or a[i] when b is null)
// accumulates into the sum. Reference behavior: the segment iterator's late
// materialization (be/src/storage/rowset/segment_iterator) — predicate
// columns are read once and non-matching rows never touch the value columns.
// ops: 0 eq, 1 ne, 2 lt, 3 le, 4 gt, 5 ge.

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

static inline bool fs_pass(int64_t v, int32_t op, int64_t w) {
  switch (op) {
    case 0: return v == w;
    case 1: return v != w;
    case 2: return v < w;
    case 3: return v <= w;
    case 4: return v > w;
    default: return v >= w;
  }
}

void sr_fused_filter_sum_i64_mt(const int64_t** pred_cols,
                                const int32_t* ops, const int64_t* vals,
                                int32_t npreds, const int64_t* a,
                                const int64_t* b, int64_t n,
                                int64_t* out_sum, int64_t* out_count,
                                int32_t nthreads) {
  if (nthreads < 1) nthreads = 1;
  auto work = [&](int64_t lo, int64_t hi, int64_t* psum, int64_t* pcnt) {
    int64_t s = 0, c = 0;
    for (int64_t i = lo; i < hi; i++) {
      bool pass = true;
      for (int32_t p = 0; p < npreds; p++) {
        if (!fs_pass(pred_cols[p][i], ops[p], vals[p])) {
          pass = false;
          break;
        }
      }
      if (pass) {
        s += b ? a[i] * b[i] : a[i];
        c++;
      }
    }
    *psum = s;
    *pcnt = c;
  };
  if (nthreads == 1 || n < 1 << 16) {
    work(0, n, out_sum, out_count);
    return;
  }
  std::vector<int64_t> sums(nthreads, 0), cnts(nthreads, 0);
  std::vector<std::thread> ts;
  int64_t step = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; t++) {
    int64_t lo = t * step, hi = std::min(n, lo + step);
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi, &sums[t], &cnts[t]);
  }
  for (auto& t : ts) t.join();
  int64_t s = 0, c = 0;
  for (int t = 0; t < nthreads; t++) {
    s += sums[t];
    c += cnts[t];
  }
  *out_sum = s;
  *out_count = c;
}

}  // extern "C"
