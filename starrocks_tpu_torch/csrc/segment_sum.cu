// Grouped float32 sums (the aggregation's float segment sum).
//
// Replaces the TPU kernel segment_sum_pallas (starrocks_tpu/ops/
// pallas_kernels.py:60, body _agg_block_kernel :42). Contract, as there:
// `gid` [n] int32 in [0, g] (g = the group count; id g takes dead rows;
// out-of-range ids are clamped into it), `vals` [n, m] float32; the result
// is [g, m] float32, the per-group column sums. The TPU kernel walks row
// blocks in order on one core, each block's partial a one-hot product,
// added up block after block in VMEM. Its `block` only fixes that order;
// this kernel does not need it.
//
// What bounds it on an H100: bytes — n * (4 + 4m) in and g * m * 4 out,
// one add per value (at S1's shape, 480 MB: 0.143 ms at 3.35 TB/s). So the
// design streams the input once with 16-byte loads over a grid that fills
// the card, keeps every partial sum on chip, and writes only a small
// partial per CTA. What holds it above that bound is the latency of the
// warp collectives per row (a match, then five shuffle levels): the four
// rows' trees run interleaved, and 16 warps per CTA (32 per SM) keep
// enough of them in flight.
//
// Design, two passes:
// - pass 1: `ctas` CTAs (264 at most; a function of n alone, computed by
//   the caller: ops/kernels.segment_sum_partition), each over one
//   contiguous range of `rows_per_cta` rows (a multiple of 2048). A CTA
//   has `warps` warps (16, fewer where 16 copies of the accumulator do not
//   fit); each warp owns a private [g + 1, m] accumulator in shared memory.
//   The warps walk the range in tiles of warps * 128 rows: warp w takes
//   rows [w * 128, (w + 1) * 128) of each tile, lane l rows 4l .. 4l + 3
//   of those (one int4 of ids, one float4 of values where m = 1). For each
//   of its four rows j, `__match_any_sync` on the group id gives the lanes
//   of one group; a shuffle tree over them, pairwise in lane order, sums
//   their values, and the lowest lane adds the sum into its warp's copy,
//   rows in order. Distinct groups hit distinct words and no two warps
//   share a copy, so there are no atomics. At the end the CTA adds its
//   warps' copies in warp order and writes one [g, m] partial (the dead
//   group is dropped).
// - pass 2: one CTA of 8 warps per 32 consecutive (group, column) cells;
//   warp w adds the partials of CTAs w, w + 8, w + 16, ... in that order,
//   and the 8 warp sums are added in warp order.
//
// Order of addition and determinism: every add above has a fixed place
// (lane tree, then the warp's chain over its tiles, then warps, then CTAs
// strided by 8, then the 8 chains), set by n, g and m alone — never by the
// card's SM count or the scheduling. No float atomics anywhere, so the
// same inputs give bit-identical sums on every run and every card. The
// order differs from the TPU's (one long chain of block partials); it is
// closer to an f64 sum (tests/test_torch_kernel_layouts.py models it in
// numpy, and the card's sums are held to an f64 sum at 1e-6 * sum |x|).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerLane = 4;
constexpr int kRowsPerWarp = 32 * kRowsPerLane;
constexpr int kCombineWarps = 8;
constexpr int kMaxWarps = 16;

// For each of a lane's four rows j: the sum of x[j] over the lanes of its
// match set, pairwise in lane order — at level l the lane of rank r (r a
// multiple of 2^(l+1)) adds the value of rank r + 2^l. Only the set's
// lowest lane ends with the whole sum. `higher[j]` holds the set's lanes
// above this one, `rank[j]` this lane's rank in it. Five levels cover any
// set of a warp; a level with nothing left to add changes nothing, so the
// levels run branch-free, the four rows' chains interleaved.
__device__ __forceinline__ void sum_sets(
    const unsigned (&higher)[kRowsPerLane], const int (&rank)[kRowsPerLane],
    float (&x)[kRowsPerLane]) {
  unsigned h[kRowsPerLane];
  int r[kRowsPerLane];
#pragma unroll
  for (int j = 0; j < kRowsPerLane; ++j) {
    h[j] = higher[j];
    r[j] = rank[j];
  }
#pragma unroll
  for (int l = 0; l < 5; ++l) {
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) {
      const int next = __ffs(h[j]);
      const float t = __shfl_sync(kFull, x[j], (next - 1) & 31);
      x[j] = next ? x[j] + t : x[j];
      h[j] &= __ballot_sync(kFull, !(r[j] & 1));
      r[j] >>= 1;
    }
  }
}

template <bool kOneColumn>
__global__ void __launch_bounds__(kMaxWarps * 32)
segment_partials_kernel(const int* __restrict__ gid,
                        const float* __restrict__ vals, long long n,
                        long long rows_per_cta, int g, int m,
                        float* __restrict__ partial) {
  extern __shared__ float acc[];  // [warps][(g + 1) * m]
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int width = (g + 1) * m;
  for (int j = threadIdx.x; j < warps * width; j += blockDim.x) acc[j] = 0.f;
  __syncthreads();

  float* mine = acc + warp * width;
  const long long begin = (long long)blockIdx.x * rows_per_cta;
  const long long end = min(begin + rows_per_cta, n);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(gid) |
        (kOneColumn ? reinterpret_cast<uintptr_t>(vals) : 0)) & 15) == 0;
  const unsigned lower = (1u << lane) - 1;
  for (long long base = begin + (long long)warp * kRowsPerWarp; base < end;
       base += (long long)warps * kRowsPerWarp) {
    const long long r0 = base + lane * kRowsPerLane;
    int k[kRowsPerLane];
    float v[kRowsPerLane];
    if (aligned && r0 + kRowsPerLane <= end) {
      const int4 k4 = __ldg(reinterpret_cast<const int4*>(gid + r0));
      k[0] = k4.x; k[1] = k4.y; k[2] = k4.z; k[3] = k4.w;
      if (kOneColumn) {
        const float4 v4 = __ldg(reinterpret_cast<const float4*>(vals + r0));
        v[0] = v4.x; v[1] = v4.y; v[2] = v4.z; v[3] = v4.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRowsPerLane; ++j) {
        const bool live = r0 + j < end;
        k[j] = live ? __ldg(gid + r0 + j) : 0;
        if (kOneColumn) v[j] = live ? __ldg(vals + r0 + j) : 0.f;
      }
    }
    // rows past the range form their own set (-1) and write nothing
    int key[kRowsPerLane], rank[kRowsPerLane];
    unsigned higher[kRowsPerLane];
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) {
      key[j] = r0 + j < end ? min(max(k[j], 0), g) : -1;
      const unsigned peers = __match_any_sync(kFull, key[j]);
      rank[j] = __popc(peers & lower);
      higher[j] = peers & ~lower & ~(1u << lane);
    }
    // the leaders add the sets' sums in row order; two rows' leaders may
    // be different lanes adding into one word, hence the warp barriers
    if (kOneColumn) {
      sum_sets(higher, rank, v);
#pragma unroll
      for (int j = 0; j < kRowsPerLane; ++j) {
        if (key[j] >= 0 && rank[j] == 0) mine[key[j]] += v[j];
        __syncwarp();
      }
    } else {
      for (int c = 0; c < m; ++c) {
#pragma unroll
        for (int j = 0; j < kRowsPerLane; ++j)
          v[j] = key[j] >= 0 ? __ldg(vals + (r0 + j) * m + c) : 0.f;
        sum_sets(higher, rank, v);
#pragma unroll
        for (int j = 0; j < kRowsPerLane; ++j) {
          if (key[j] >= 0 && rank[j] == 0) mine[key[j] * m + c] += v[j];
          __syncwarp();
        }
      }
    }
  }
  __syncthreads();
  const int cells = g * m;  // the dead group's cells are dropped
  float* out = partial + (long long)blockIdx.x * cells;
  for (int j = threadIdx.x; j < cells; j += blockDim.x) {
    float s = acc[j];
    for (int w = 1; w < warps; ++w) s += acc[w * width + j];
    out[j] = s;
  }
}

__global__ void __launch_bounds__(kCombineWarps * 32)
segment_combine_kernel(const float* __restrict__ partial, int ctas,
                       int cells, float* __restrict__ out) {
  __shared__ float chain[kCombineWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (j < cells) {
#pragma unroll 8
    for (int q = warp; q < ctas; q += kCombineWarps)
      s += __ldg(partial + (long long)q * cells + j);
  }
  chain[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && j < cells) {
    float t = chain[0][lane];
#pragma unroll
    for (int w = 1; w < kCombineWarps; ++w) t += chain[w][lane];
    out[j] = t;
  }
}

}  // namespace

extern "C" {

// gid [n] int32, vals [n, m] float32; `ctas` CTAs of `warps` warps over
// `rows_per_cta` rows each (rows_per_cta * ctas >= n); partial [ctas, g, m]
// float32 scratch; out [g, m] float32. warps * (g + 1) * m * 4 bytes of
// shared memory per CTA, at most what the card offers (checked by the
// caller). Returns cudaGetLastError().
int sr_segment_sum(const void* gid, const void* vals, long long n, int m,
                   int g, long long ctas, long long rows_per_cta, int warps,
                   void* partial, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ctas > 0) {
    const size_t smem = (size_t)warps * (g + 1) * m * sizeof(float);
    const bool one = m == 1;
    auto kernel = one ? segment_partials_kernel<true>
                      : segment_partials_kernel<false>;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kernel<<<(unsigned int)ctas, warps * 32, smem, s>>>(
        (const int*)gid, (const float*)vals, n, rows_per_cta, g, m,
        (float*)partial);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int cells = g * m;
  if (cells > 0) {
    segment_combine_kernel<<<(cells + 31) / 32, kCombineWarps * 32, 0, s>>>(
        (const float*)partial, (int)ctas, cells, (float*)out);
  }
  return (int)cudaGetLastError();
}

const char* sr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
