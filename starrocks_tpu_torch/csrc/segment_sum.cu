// Grouped float32 sums over row blocks (the aggregation's float segment sum).
//
// Replaces the TPU kernel segment_sum_pallas (starrocks_tpu/ops/
// pallas_kernels.py:60, body _agg_block_kernel :42). Contract, as there:
// `gid` [n] int32 in [0, g] (g = the group count; id g takes dead rows),
// `vals` [n, m] float32, n a multiple of `block`; the result is [g, m]
// float32, the per-group column sums. The TPU kernel walks the row blocks in
// order on one core: each block's partial sums come from a one-hot product,
// and an accumulator in VMEM adds them up block after block in float32.
//
// Blocks run in parallel here, so the order across blocks is made explicit:
// pass 1 computes every block's [g + 1, m] partial, pass 2 adds the
// partials of each (group, column) in block order, in float32 — the TPU's
// order across blocks, and the same on every run. Within a block the
// partial comes from shared-memory atomics, whose order varies from run to
// run; the result differs from the TPU's only in that order (relative
// differences of the order of 1e-7 of a block partial).
//
// What bounds it on an H100: bytes — n * (4 + 4m) in and g * m * 4 out, a
// few flops per element. This simple design moves more: the partials
// (n / block * (g + 1) * m * 4 bytes) are written once and read once, pass 2
// runs only g * m threads (each a sequential chain of n / block dependent
// adds), and rows of one group contend for one shared-memory address in
// pass 1. Warp-level pre-aggregation and a tree of partial sums are later
// work.
//
// Design: pass 1, one CTA per row block, a [g + 1, m] float32 accumulator
// in (dynamic) shared memory, zeroed, atomically added to by 256 threads
// striding over the block's rows, then written out; pass 2, one thread per
// (group, column) over the first g groups.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
segment_partials_kernel(const int* __restrict__ gid,
                        const float* __restrict__ vals, int block, int g,
                        int m, float* __restrict__ partial) {
  extern __shared__ float acc[];
  const int width = (g + 1) * m;
  for (int j = threadIdx.x; j < width; j += kThreads) acc[j] = 0.f;
  __syncthreads();
  const long long row0 = (long long)blockIdx.x * block;
  for (int r = threadIdx.x; r < block; r += kThreads) {
    int k = gid[row0 + r];
    k = k < 0 ? 0 : (k > g ? g : k);
    const float* v = vals + (row0 + r) * m;
    for (int c = 0; c < m; ++c) atomicAdd(&acc[k * m + c], v[c]);
  }
  __syncthreads();
  float* out = partial + (long long)blockIdx.x * width;
  for (int j = threadIdx.x; j < width; j += kThreads) out[j] = acc[j];
}

__global__ void __launch_bounds__(kThreads)
segment_combine_kernel(const float* __restrict__ partial, long long nb,
                       int width, int n_out, float* __restrict__ out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n_out) return;
  const float* p = partial + j;
  float s = 0.f;
  long long b = 0;
  for (; b + kUnroll <= nb; b += kUnroll) {
    float x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) x[u] = __ldg(p + (b + u) * width);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) s += x[u];  // block order
  }
  for (; b < nb; ++b) s += __ldg(p + b * width);
  out[j] = s;
}

}  // namespace

extern "C" {

// gid [n] int32, vals [n, m] float32, n % block == 0; partial [n/block,
// g+1, m] float32 scratch; out [g, m] float32. (g+1)*m*4 bytes of shared
// memory per CTA, at most what the card offers (checked by the caller).
// Returns cudaGetLastError().
int sr_segment_sum(const void* gid, const void* vals, long long n, int m,
                   int g, int block, void* partial, void* out, void* stream) {
  const long long nb = n / block;
  const int width = (g + 1) * m;
  const size_t smem = (size_t)width * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        segment_partials_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (nb > 0) {
    segment_partials_kernel<<<(unsigned int)nb, kThreads, smem, s>>>(
        (const int*)gid, (const float*)vals, block, g, m, (float*)partial);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int n_out = g * m;
  if (n_out > 0) {
    segment_combine_kernel<<<(n_out + kThreads - 1) / kThreads, kThreads, 0,
                             s>>>((const float*)partial, nb, width, n_out,
                                  (float*)out);
  }
  return (int)cudaGetLastError();
}

const char* sr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
