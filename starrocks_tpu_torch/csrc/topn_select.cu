// Per-block top-k candidate select for threshold top-N (ORDER BY .. LIMIT).
//
// Replaces the TPU kernel topn_select_pallas (starrocks_tpu/ops/
// pallas_kernels.py:112, body _topn_block_kernel :86). Contract, as there:
// for each 1024-row block of `neg` (int64, bigger = better) emit the block's
// first k rows in the order value descending, then row index ascending, as
// (value, global row index) pairs; the caller reduces the nblocks*k
// candidates (ops/sort.py topn_order).
//
// One detail of the TPU kernel is kept on purpose. It runs k rounds of
// (max, first argmax, overwrite with INT64_MIN); a lane that holds INT64_MIN
// (the complement of the dead-row code) is then indistinguishable from an
// already-taken lane, so once only such lanes remain every further round
// returns lane 0 of the block. This kernel writes (INT64_MIN, block base) in
// those positions, so its output equals the TPU kernel's bit for bit.
//
// What bounds it on an H100: bytes — N keys read once (8 B each) and
// nblocks*k (value, row) pairs written (12 B each): at the SQL path's k of
// 1024 and N 60,005,376 (lineitem at SF 10) 1.2 GB, 0.358 ms at 3.35 TB/s.
// A comparison sort of 1024 keys needs about log2(1024!) = 8,770 compares,
// far below that. What a sorting network costs instead is instructions on
// the integer pipes (half the FP32 rate): a bitonic network has 55 stages
// of 512 compare-exchanges a block, each on 64-bit keys two compares and
// four selects. The design cuts that count three ways: 32-bit keys where
// they order the block (one min and one max a compare-exchange), no lane
// carried beside the key, and a loop around the large merges so that the
// code stays in the instruction caches.
//
// Design:
// - One warp sorts one block, with 32 keys a lane in registers in the
//   blocked layout (element e = 32 * lane + r). CTAs of 4 warps are
//   persistent, a few per SM; each warp walks the blocks b = its global
//   warp id + i * (all warps). No barrier of the CTA is ever taken.
// - The keys. With lo the block's least live value (all but INT64_MIN)
//   and span = max - lo, a row's 64-bit key is ((v - lo) << 10 | (1023 -
//   lane)) + 1 and its 32-bit key ((v - lo) >> shift << 10 | (1023 -
//   lane)) + 1, where the shift (0 while span < 2^22 - 1) keeps the top 22
//   bits of the span; an INT64_MIN row's keys are 0. Keys are distinct
//   (the lane), order as (value desc, lane asc), and dead keys sort last
//   and all emit (INT64_MIN, block base); no lane rides beside the key.
// - The first pass sorts the 32-bit keys, then reads each row's 64-bit
//   key from the shared buffer through its lane. Where the shift is not 0,
//   rows whose prefixes tie are still in lane order: while the 64-bit keys
//   are not descending (a warp vote), an odd-even transposition pass
//   orders them, up to kMaxPasses passes (a tie of up to 8 rows). On N1's
//   keys (spans ~2^52, 22-bit prefixes) that is 0.125 tied pairs a block.
// - A block whose ties need more passes is listed for the second pass,
//   the same network on the 64-bit keys (two compares and four selects a
//   compare-exchange). A block whose span exceeds 2^54 - 2 (keys that use
//   more than 54 bits within one block; the SQL path's packed keys have
//   at most 62) is listed for a third kernel: one CTA of 1024 threads per
//   block sorting (value, lane) pairs in shared memory, 55 barrier-
//   separated stages (the first design of this kernel).
// - The network is the bitonic sort whose first stage of each merge
//   compares e with its mirror e ^ (size - 1), so every compare-exchange
//   puts the larger key at the lower position: no direction bit. Strides
//   below 32 stay inside a lane (40 of the 55 stages, compile-time
//   register indices); strides of 32 and more pair lane with lane ^
//   (stride / 32) at the same r, through __shfl_xor_sync (15 stages; the
//   mirror stage sends r and 31 - r together).
// - Loads: the next block's 8 KB is copied into the warp's shared buffer
//   with cp.async (16 B a lane and copy, coalesced) while the warp stores
//   the current one. The buffer's 16-byte chunks are XOR-swizzled within
//   each 256-byte row (chunk c of row R at c ^ (R & 15)), so the blocked
//   read (two keys a lane) and the striped read after the sort (a warp
//   reads one row) are free of bank conflicts.
// - Stores: the sorted keys go back through the same buffer and leave in
//   rank order e = 32 * i + lane: 256 B of values and 128 B of rows per
//   warp and store, coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kBlock = 1024;
constexpr int kKeys = kBlock / 32;  // keys a lane holds
constexpr int kWarps = 4;           // warps a CTA of the sort kernel
// CTAs of the sort kernels an SM must fit (a bound on their registers):
// the first pass (32-bit keys) and the 64-bit pass
constexpr int kMinCtas = 3;
constexpr int kMinCtasWide = 2;
constexpr int kLaneBits = 10;
// the widest live span (max - min) the 64-bit key holds
constexpr u64 kMaxSpan = (1ull << (64 - kLaneBits)) - 2;
// bits of (v - min) in the 32-bit key, above the lane's 10
constexpr int kPrefixBits = 32 - kLaneBits;
// transposition passes that may order rows whose 32-bit keys tie on the
// prefix (a run of up to 2 * kMaxPasses rows) before the block goes to
// the 64-bit pass
constexpr int kMaxPasses = 4;
constexpr long long kInt64Min = (long long)(-0x7FFFFFFFFFFFFFFFLL - 1);
constexpr long long kInt64Max = 0x7FFFFFFFFFFFFFFFLL;
constexpr unsigned kFull = 0xffffffffu;

// Index, in 8-byte words, of element e of a block in a warp's buffer: row
// e / 32 of 256 B, its 16-byte chunks XOR-swizzled by the row.
__device__ __forceinline__ int slot_of(int e) {
  const int row = e >> 5;
  const int chunk = ((e & 31) >> 1) ^ (row & 15);
  return (row << 5) | (chunk << 1) | (e & 1);
}

__device__ __forceinline__ void cp_async16(u64* smem, const long long* g) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(g));
}

__device__ __forceinline__ void cp_async8(u64* smem, const long long* g) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(g));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy block `src` (1024 keys) into the warp's swizzled buffer: 16-byte
// copies where `src` is 16-byte aligned, else 8-byte ones.
template <bool kVec16>
__device__ __forceinline__ void load_block(u64* buf, const long long* src,
                                           int lane) {
  if (kVec16) {
#pragma unroll
    for (int i = 0; i < kBlock / 64; ++i) {
      const int e = 2 * (i * 32 + lane);
      cp_async16(buf + slot_of(e), src + e);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      const int e = i * 32 + lane;
      cp_async8(buf + slot_of(e), src + e);
    }
  }
  cp_async_commit();
}

// Larger key to the lower position.
__device__ __forceinline__ void exchange(unsigned& hi, unsigned& lo) {
  const unsigned a = hi, b = lo;
  hi = max(a, b);
  lo = min(a, b);
}

__device__ __forceinline__ void exchange(u64& hi, u64& lo) {
  const u64 a = hi, b = lo;
  const bool swap = a < b;
  hi = swap ? b : a;
  lo = swap ? a : b;
}

// The larger of k and o where `larger`, else the smaller.
__device__ __forceinline__ unsigned pick(unsigned k, unsigned o, bool larger) {
  return larger ? max(k, o) : min(k, o);
}

__device__ __forceinline__ u64 pick(u64 k, u64 o, bool larger) {
  return ((k > o) == larger) ? k : o;
}

// The bitonic merge of 32 keys inside a lane (strides 16 .. 1).
template <typename K>
__device__ __forceinline__ void merge_in_lane(K (&key)[kKeys]) {
#pragma unroll
  for (int ss = 4; ss >= 0; --ss) {
#pragma unroll
    for (int r = 0; r < kKeys; ++r) {
      const int q = r ^ (1 << ss);
      if (r < q) exchange(key[r], key[q]);
    }
  }
}

// Sort the warp's 1024 keys descending; key[r] holds element 32 * lane + r.
// Every loop over r unrolls, so every register index is a constant. The
// merges of sizes 64 .. 1024 share one copy of their code (a loop that
// does not unroll): unrolled, the 64-bit network is ~21,000 instructions,
// more than the instruction caches hold, and ran 2.5x slower.
template <typename K>
__device__ __forceinline__ void sort_block(K (&key)[kKeys], int lane) {
  // sizes 2 .. 32: inside the lane
#pragma unroll
  for (int ls = 1; ls <= 5; ++ls) {
#pragma unroll
    for (int r = 0; r < kKeys; ++r) {
      const int q = r ^ ((1 << ls) - 1);
      if (r < q) exchange(key[r], key[q]);
    }
#pragma unroll
    for (int ss = ls - 2; ss >= 0; --ss) {
#pragma unroll
      for (int r = 0; r < kKeys; ++r) {
        const int q = r ^ (1 << ss);
        if (r < q) exchange(key[r], key[q]);
      }
    }
  }
  // sizes 64 .. 1024: the mirror and the strides >= 32 across lanes, then
  // the strides 16 .. 1 inside the lane
#pragma unroll 1
  for (int ls = 6; ls <= 10; ++ls) {
    {
      const int mask = (1 << (ls - 5)) - 1;
      const bool lower = (lane & (1 << (ls - 6))) == 0;
#pragma unroll
      for (int r = 0; r < kKeys / 2; ++r) {
        // the partner of (lane, r) is (lane ^ mask, 31 - r)
        const K a = __shfl_xor_sync(kFull, key[kKeys - 1 - r], mask);
        const K b = __shfl_xor_sync(kFull, key[r], mask);
        key[r] = pick(key[r], a, lower);
        key[kKeys - 1 - r] = pick(key[kKeys - 1 - r], b, lower);
      }
    }
#pragma unroll 1
    for (int ss = ls - 2; ss >= 5; --ss) {
      const int mask = 1 << (ss - 5);
      const bool lower = (lane & mask) == 0;
#pragma unroll
      for (int r = 0; r < kKeys; ++r) {
        key[r] = pick(key[r], __shfl_xor_sync(kFull, key[r], mask), lower);
      }
    }
    merge_in_lane(key);
  }
}

// Whether the warp's 64-bit keys are in descending order (blocked layout).
__device__ __forceinline__ bool sorted_desc(const u64 (&key)[kKeys],
                                            int lane) {
  bool ok = true;
#pragma unroll
  for (int r = 0; r + 1 < kKeys; ++r) ok &= key[r] >= key[r + 1];
  const u64 next = __shfl_down_sync(kFull, key[0], 1);
  ok &= lane == 31 || key[kKeys - 1] >= next;
  return __all_sync(kFull, ok);
}

// One odd-even transposition pass over the warp's 1024 keys (blocked
// layout): pairs (2i, 2i + 1), then (2i + 1, 2i + 2), the pair across two
// lanes through shuffles.
__device__ __forceinline__ void transposition_pass(u64 (&key)[kKeys],
                                                   int lane) {
#pragma unroll
  for (int r = 0; r < kKeys; r += 2) exchange(key[r], key[r + 1]);
#pragma unroll
  for (int r = 1; r + 1 < kKeys; r += 2) exchange(key[r], key[r + 1]);
  const u64 next = __shfl_down_sync(kFull, key[0], 1);
  const u64 prev = __shfl_up_sync(kFull, key[kKeys - 1], 1);
  if (lane < 31) key[kKeys - 1] = key[kKeys - 1] > next ? key[kKeys - 1] : next;
  if (lane > 0) key[0] = key[0] < prev ? key[0] : prev;
}

// The 64-bit key of a row: ((v - lo) << 10 | (1023 - e)) + 1, and 0 for an
// INT64_MIN (dead) row.
__device__ __forceinline__ u64 wide_key(long long v, long long lo, int e) {
  return v == kInt64Min
             ? 0ull
             : ((((u64)v - (u64)lo) << kLaneBits) | (u64)(kBlock - 1 - e)) + 1;
}

// The scratch the wrapper hands over: two counts, then the blocks for the
// 64-bit pass and the blocks for the pair kernel.
struct Lists {
  int* count;  // [0]: the 64-bit pass's blocks, [1]: the pair kernel's
  int* wide;   // [nblocks]
  int* pairs;  // [nblocks]
};

// One warp per block (see the note at the top). kWide: the second pass,
// over the blocks listed in `lists.wide`, with 64-bit keys.
template <bool kVec16, bool kWide>
__global__ void __launch_bounds__(kWarps * 32, kWide ? kMinCtasWide : kMinCtas)
topn_sort_kernel(const long long* __restrict__ neg, long long nblocks, int k,
                 long long* __restrict__ vals, int* __restrict__ idx,
                 Lists lists) {
  __shared__ __align__(16) u64 bufs[kWarps][kBlock];
  const int lane = threadIdx.x & 31;
  u64* buf = bufs[threadIdx.x >> 5];
  const long long total = kWide ? (long long)lists.count[0] : nblocks;
  const long long step = (long long)gridDim.x * kWarps;
  long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  auto block_of = [&](long long j) -> long long {
    return kWide ? (long long)lists.wide[j] : j;
  };
  if (i < total) load_block<kVec16>(buf, neg + block_of(i) * kBlock, lane);
  for (; i < total; i += step) {
    const long long b = block_of(i);
    const bool has_next = i + step < total;
    cp_async_wait_all();
    __syncwarp();
    long long raw[kKeys];
#pragma unroll
    for (int r = 0; r < kKeys; r += 2) {
      const longlong2 p =
          *reinterpret_cast<const longlong2*>(buf + slot_of(lane * kKeys + r));
      raw[r] = p.x;
      raw[r + 1] = p.y;
    }
    // the live span
    long long lo = kInt64Max, hi = kInt64Min;
#pragma unroll
    for (int r = 0; r < kKeys; ++r) {
      if (raw[r] != kInt64Min) {
        lo = raw[r] < lo ? raw[r] : lo;
        hi = raw[r] > hi ? raw[r] : hi;
      }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      const long long ol = __shfl_xor_sync(kFull, lo, m);
      const long long oh = __shfl_xor_sync(kFull, hi, m);
      lo = ol < lo ? ol : lo;
      hi = oh > hi ? oh : hi;
    }
    // (hi stays INT64_MIN only where every row is dead)
    const u64 span = hi == kInt64Min ? 0 : (u64)hi - (u64)lo;
    int listed = -1;  // 0: to the 64-bit pass, 1: to the pair kernel
    u64 key[kKeys];
    if (span > kMaxSpan) {
      listed = 1;
    } else if (kWide) {
#pragma unroll
      for (int r = 0; r < kKeys; ++r)
        key[r] = wide_key(raw[r], lo, lane * kKeys + r);
      sort_block(key, lane);
    } else {
      // 32-bit keys: the top kPrefixBits bits of (v - lo) above the lane
      int shift = span < (1ull << kPrefixBits) - 1
                      ? 0 : 64 - __clzll((long long)span) - kPrefixBits;
      if ((span >> shift) >= (1ull << kPrefixBits) - 1) ++shift;
      unsigned key32[kKeys];
#pragma unroll
      for (int r = 0; r < kKeys; ++r) {
        const unsigned e = lane * kKeys + r;
        key32[r] = raw[r] == kInt64Min
                       ? 0u
                       : ((unsigned)(((u64)raw[r] - (u64)lo) >> shift)
                              << kLaneBits |
                          (kBlock - 1 - e)) + 1;
      }
      sort_block(key32, lane);
      // the full keys, from each row's lane, in the 32-bit keys' order;
      // rows whose prefixes tie are in lane order and get sorted by the
      // transposition passes
#pragma unroll
      for (int r = 0; r < kKeys; ++r) {
        const int e = kBlock - 1 - (int)((key32[r] - 1) & (kBlock - 1));
        key[r] = key32[r] == 0
                     ? 0ull
                     : wide_key((long long)buf[slot_of(e)], lo, e);
      }
      if (shift > 0) {
        int pass = 0;
        while (!sorted_desc(key, lane)) {
          if (pass++ == kMaxPasses) {
            listed = 0;
            break;
          }
          transposition_pass(key, lane);
        }
      }
    }
    if (listed >= 0) {
      if (lane == 0) {
        int* list = listed ? lists.pairs : lists.wide;
        list[atomicAdd(lists.count + listed, 1)] = (int)b;
      }
      __syncwarp();
      if (has_next)
        load_block<kVec16>(buf, neg + block_of(i + step) * kBlock, lane);
      continue;
    }
    // back through the buffer into rank order e = 32 * i + lane
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kKeys; r += 2) {
      *reinterpret_cast<ulonglong2*>(buf + slot_of(lane * kKeys + r)) =
          make_ulonglong2(key[r], key[r + 1]);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kKeys; ++j) key[j] = buf[slot_of(j * 32 + lane)];
    __syncwarp();
    if (has_next)
      load_block<kVec16>(buf, neg + block_of(i + step) * kBlock, lane);
    const long long base = b * kBlock;
    const long long out = b * (long long)k;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const int e = j * 32 + lane;
      if (e < k) {
        const u64 c = key[j] - 1;  // key 0 (dead) wraps to all ones
        const bool dead = key[j] == 0;
        vals[out + e] = dead ? kInt64Min : lo + (long long)(c >> kLaneBits);
        idx[out + e] =
            (int)(base + (dead ? 0 : kBlock - 1 - (int)(c & (kBlock - 1))));
      }
    }
  }
}

// The blocks listed for pairs, one CTA of 1024 threads each: their
// (value, lane) pairs in shared memory, sorted by a bitonic network in 55
// barrier-separated stages into (value desc, lane asc) order, a total
// order.
__global__ void __launch_bounds__(kBlock)
topn_pair_kernel(const long long* __restrict__ neg, int k,
                 long long* __restrict__ vals, int* __restrict__ idx,
                 Lists lists) {
  __shared__ long long sv[kBlock];
  __shared__ int si[kBlock];
  const int t = threadIdx.x;
  const int count = lists.count[1];
  for (int w = blockIdx.x; w < count; w += gridDim.x) {
    const long long b = lists.pairs[w];
    const long long base = b * kBlock;
    sv[t] = neg[base + t];
    si[t] = t;
    __syncthreads();
    for (int size = 2; size <= kBlock; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const int j = t ^ stride;
        if (j > t) {
          const long long a = sv[t], c = sv[j];
          const int ia = si[t], ic = si[j];
          // "c before a" in (value desc, lane asc) order
          const bool c_first = (c > a) || (c == a && ic < ia);
          const bool up = (t & size) == 0;
          if (c_first == up) {
            sv[t] = c;
            sv[j] = a;
            si[t] = ic;
            si[j] = ia;
          }
        }
        __syncthreads();
      }
    }
    if (t < k) {
      const long long v = sv[t];
      const long long out = b * k + t;
      vals[out] = v;
      idx[out] = (int)(base + (v == kInt64Min ? 0 : si[t]));
    }
    __syncthreads();
  }
}

// CTAs for a persistent grid of `kernel`: as many as fit on the card, at
// most `need`.
template <typename F>
cudaError_t persistent_ctas(F kernel, int threads, long long need,
                            long long* ctas) {
  cudaError_t e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    0);
  if (e != cudaSuccess) return e;
  *ctas = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (*ctas > need) *ctas = need;
  return cudaSuccess;
}

template <bool kVec16>
int launch_sort(const long long* neg, long long nblocks, int k,
                long long* vals, int* idx, int* scratch, cudaStream_t st) {
  const Lists lists{scratch, scratch + 2, scratch + 2 + nblocks};
  const long long need = (nblocks + kWarps - 1) / kWarps;
  long long narrow = 0, wide = 0, pairs = 0;
  cudaError_t e;
  if ((e = persistent_ctas(topn_sort_kernel<kVec16, false>, kWarps * 32, need,
                           &narrow)) != cudaSuccess ||
      (e = persistent_ctas(topn_sort_kernel<kVec16, true>, kWarps * 32, need,
                           &wide)) != cudaSuccess ||
      (e = persistent_ctas(topn_pair_kernel, kBlock, nblocks, &pairs)) !=
          cudaSuccess)
    return (int)e;
  if ((e = cudaMemsetAsync(scratch, 0, 2 * sizeof(int), st)) != cudaSuccess)
    return (int)e;
  topn_sort_kernel<kVec16, false><<<(unsigned int)narrow, kWarps * 32, 0, st>>>(
      neg, nblocks, k, vals, idx, lists);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  topn_sort_kernel<kVec16, true><<<(unsigned int)wide, kWarps * 32, 0, st>>>(
      neg, nblocks, k, vals, idx, lists);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  topn_pair_kernel<<<(unsigned int)pairs, kBlock, 0, st>>>(neg, k, vals, idx,
                                                         lists);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// neg [n] int64 with n % 1024 == 0; 1 <= k <= 1024; vals [n/1024*k] int64,
// idx [n/1024*k] int32; scratch [2 + 2 * n/1024] int32 (two counts and two
// lists of blocks: for the 64-bit pass and for the pair kernel). Returns
// cudaGetLastError().
int sr_topn_select(const void* neg, long long n, int k, void* vals, void* idx,
                   void* scratch, void* stream) {
  const long long nblocks = n / kBlock;
  if (nblocks == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (((uintptr_t)neg & 15) == 0)
    return launch_sort<true>((const long long*)neg, nblocks, k,
                             (long long*)vals, (int*)idx, (int*)scratch, st);
  return launch_sort<false>((const long long*)neg, nblocks, k,
                            (long long*)vals, (int*)idx, (int*)scratch, st);
}

const char* sr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
