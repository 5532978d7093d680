// Lower-bound search of join probe keys in the sorted build keys.
//
// Replaces the TPU kernel probe_searchsorted_pallas (starrocks_tpu/ops/
// pallas_kernels.py:316, body _probe_block_kernel :295). Contract, as there:
// `build` [k] int64 sorted ascending (NULL/dead rows carry the int64-max
// sentinel and sort last), `probe` [n] int64; pos[i] is the first index j
// with build[j] >= probe[i] (k when there is none), as int32 — that is
// searchsorted(build, probe, side='left').
//
// The TPU kernel keeps the whole build side in VMEM and runs a branch-free
// ladder of bit_length(k) masked halving steps over a probe block in
// lockstep, because its vector unit has no per-lane control flow. A CUDA
// thread has its own control flow, so each thread runs the plain lower-bound
// loop for one probe key; the loop takes the same ceil(log2(k + 1)) steps
// and gives the same answer for every sorted input, duplicates and the
// int64 extremes included.
//
// What bounds it on an H100: the bytes are n * 12 (key in, position out)
// plus the build's k * 8, but the searches read build[mid] at data-dependent
// addresses: at the main path's shape (k = 8M keys, 64 MB) the lower levels
// of every search miss the 50 MB L2 and wait on DRAM latency, so this
// simple kernel runs well above the byte bound. Caching the top levels of
// the search tree in shared memory is the next step, not taken here.
//
// Design: one thread per probe, 256 threads per CTA, build loads through
// the read-only path (__ldg).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
probe_searchsorted_kernel(const long long* __restrict__ build, long long k,
                          const long long* __restrict__ probe, long long n,
                          int* __restrict__ pos) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long key = probe[i];
  long long lo = 0, hi = k;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (__ldg(build + mid) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  pos[i] = (int)lo;
}

}  // namespace

extern "C" {

// build [k] int64 sorted, probe [n] int64, pos [n] int32; k < 2^31.
// Returns cudaGetLastError().
int sr_probe_searchsorted(const void* build, long long k, const void* probe,
                          long long n, void* pos, void* stream) {
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    probe_searchsorted_kernel<<<(unsigned int)blocks, kThreads, 0,
                                (cudaStream_t)stream>>>(
        (const long long*)build, k, (const long long*)probe, n, (int*)pos);
  }
  return (int)cudaGetLastError();
}

const char* sr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
