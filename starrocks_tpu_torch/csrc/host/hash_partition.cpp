// The host partitioner of the spill executors (runtime/batched.py: the
// hybrid and grace joins route both join inputs by the key's bucket, the
// spilled window its rows by the PARTITION BY key's), built on its own at
// first use by starrocks_tpu_torch/native.py.
//
// sr_hash_partition_i64_mt: a copy of the JAX package's
// native/sr_native.cpp function. out[i] = mix64(keys[i] * GOLDEN) mod
// nbuckets, over uint64: the same buckets as the TabletStore's bucketing
// and as the numpy version in native.py, bit for bit (INT64_MIN,
// INT64_MAX and negative keys included).
//
// sr_bucket_order_i32_mt: the stable counting sort of row ids by bucket
// (numpy's argsort(bucket, kind="stable")) and each bucket's first
// position: per-thread histograms over contiguous row ranges, one prefix
// sum in (bucket, thread) order, then each thread scatters its rows.

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

static inline uint64_t mix64(uint64_t z) {
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

void sr_hash_partition_i64_mt(const int64_t* keys, int64_t n, int32_t nbuckets,
                              int32_t* out, int32_t nthreads) {
  if (nthreads < 1) nthreads = 1;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; i++) {
      out[i] =
          (int32_t)(mix64((uint64_t)keys[i] * 0x9E3779B97F4A7C15ULL) %
                    (uint64_t)nbuckets);
    }
  };
  if (nthreads == 1 || n < 1 << 16) {
    work(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t step = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; t++) {
    int64_t lo = t * step, hi = std::min(n, lo + step);
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& t : ts) t.join();
}

void sr_bucket_order_i32_mt(const int32_t* bucket, int64_t n, int32_t nb,
                            int64_t* order, int64_t* offsets,
                            int32_t nthreads) {
  if (nthreads < 1) nthreads = 1;
  if (n < 1 << 16) nthreads = 1;
  int64_t step = (n + nthreads - 1) / nthreads;
  std::vector<int64_t> hist((size_t)nthreads * nb, 0);
  auto count = [&](int t) {
    int64_t lo = t * step, hi = std::min(n, lo + step);
    int64_t* h = hist.data() + (size_t)t * nb;
    for (int64_t i = lo; i < hi; i++) h[bucket[i]]++;
  };
  auto scatter = [&](int t) {
    int64_t lo = t * step, hi = std::min(n, lo + step);
    int64_t* h = hist.data() + (size_t)t * nb;
    for (int64_t i = lo; i < hi; i++) order[h[bucket[i]]++] = i;
  };
  std::vector<std::thread> ts;
  for (int t = 1; t < nthreads; t++) ts.emplace_back(count, t);
  count(0);
  for (auto& t : ts) t.join();
  ts.clear();
  int64_t pos = 0;
  for (int32_t b = 0; b < nb; b++) {
    offsets[b] = pos;
    for (int t = 0; t < nthreads; t++) {
      int64_t c = hist[(size_t)t * nb + b];
      hist[(size_t)t * nb + b] = pos;
      pos += c;
    }
  }
  offsets[nb] = pos;
  for (int t = 1; t < nthreads; t++) ts.emplace_back(scatter, t);
  scatter(0);
  for (auto& t : ts) t.join();
}

}  // extern "C"
