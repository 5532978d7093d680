// Open-addressing hash table for unique-key joins: build and probe,
// partitioned so that each CTA works on one slice of the table held in
// shared memory.
//
// Replaces the TPU kernels hash_build_pallas (starrocks_tpu/ops/
// pallas_kernels.py:206, body _hash_build_kernel :159) and hash_probe_pallas
// (:266, body _hash_probe_kernel :233). Contract, as there:
//   - slot = splitmix64(key) & (T - 1), linear probing, T a power of two
//     >= 2N (load factor <= 0.5) and <= 2^31;
//   - int64 max is both the empty-slot marker and the NULL/dead key: such
//     keys never insert and never match;
//   - the build returns table_key [T] int64 and table_row [T] int32 (-1 =
//     empty); the probe returns the matched build row, or -1.
// The TPU kernel inserts in data-parallel claim rounds (scatter-min of row
// ids), so its slot layout differs from this one; build keys are unique, so
// every probe result is the same under any valid linear-probing layout.
//
// What bounds it on an H100: bytes. The least work reads the N keys and
// writes the T slots once (12 B a slot) for the build, and reads the table
// and the M probes and writes M rows for the probe. A table larger than the
// 50 MB L2 (2^24 slots = 201 MB at TPC-H SF 10) makes each random access of
// a one-thread-per-key design a DRAM access, and a 4-byte write to a random
// place a partial-sector write: such a build ran at 0.06 of its bound. So
// both kernels move keys in bulk to the table's slices and touch the table
// only in whole slices, through shared memory; every access to device
// memory is then sequential, or in runs, except where noted below.
//
// Layout (ops/kernels.hash_partition_layout, computed on the host): the
// table is cut into P = T / S slices of S = 8192 consecutive slots (the
// whole table where it is smaller): 96 KB of keys and rows, two CTAs to an
// SM. A key's partition is its home slot >> log2(S).
//
// Build, one C call, kernels on the caller's stream:
//   1. count: each CTA counts its 8192 keys per partition in a shared-memory
//      histogram and adds each non-empty bin to counts[p] (global atomics
//      per key where P bins exceed 64 KB, P > 2^14);
//   2. scan: one CTA makes the exclusive offsets;
//   3. scatter (key, row id) into partition order. Scattering each key on
//      its own wrote 8- and 4-byte pieces to random places and took 0.45 ms
//      at Q9's shape; instead each CTA sorts a tile of 4096 keys by bin in
//      shared memory, reserves one range per bin with one global atomic,
//      and writes each bin's run with consecutive threads. For runs that
//      fill lines, the bins are at most 128: one pass up to 128 slices,
//      else two, 128 coarse bins of slices first (into the table's own
//      memory, which the insert overwrites), then the slices;
//   4. insert: one CTA per slice fills the slice in shared memory with the
//      sentinel and -1, inserts its partition's keys with shared-memory
//      64-bit atomicCAS walking linearly inside the slice, and writes the
//      whole slice out with 16-byte stores: every slot of the table is
//      written exactly once, with no fill beforehand. A key whose walk
//      reaches the end of the slice is deferred: written back to the front
//      of its partition's scratch range (each round of records is read
//      before the round's deferred keys are written, so nothing unread is
//      overwritten), and the slice records how many;
//   5. overflow: one warp per partition inserts its deferred keys into the
//      global table with a global atomicCAS walk that starts at the next
//      slice and wraps at T - 1 -> 0. This is linear probing still: a key
//      was deferred only when every slot from its home to its slice's end
//      was taken, and slots never empty again. At load 0.48 that is about
//      0.2 keys per slice boundary (434 of 8,000,512 at Q9's shape).
//
// Probe, two routes, chosen by the wrapper from (T, M) alone by the bytes
// each moves (ops/kernels.hash_partition_layout): the partitioned route
// reads the whole table, so a probe small against the table walks
// directly; so does a probe of a table of more than 2048 slices (T > 2^24),
// whose keys one scatter pass cannot group into runs.
//   - direct: one thread per probe walks its chain with read-only loads.
//   - partitioned, three kernels: a wide scatter of the probe keys alone,
//     in one pass and with no count beforehand: slice p owns `cap` places
//     (1/8 over an even share, and 64), tiles of 16384 keys are sorted by
//     slice in shared memory (runs of 8 keys and more), one atomic a slice
//     reserves a tile's run, and dest[i] records where probe i went (-1
//     for an int64-max probe, -2 where its slice's places ran out); one
//     CTA per slice loads the slice and a halo of the next 256 slots
//     (wrapping at T) into shared memory, answers its probes from there (a
//     chain past the halo continues in global memory) and writes the
//     answers by place; last, out[i] = answer[dest[i]], a gather whose
//     reads come in runs, and which walks the table itself for a probe
//     whose slice was full (one hot key in many probes: correct, and as
//     fast as the direct route for those). Writing each answer straight
//     to out[i] from the slice's CTA was 9M random 4-byte writes, and made
//     that kernel 0.35 ms instead of 0.14 at Q9's shape.
//
// Tried and dropped (on the H100, at Q9's shape): persistent CTAs with
// double-buffered slices moved by bulk copies (TMA) and transaction
// barriers, no faster; clusters of 8 CTAs holding a 131,072-slot slice in
// distributed shared memory, 3x slower in the answer.
//
// Determinism: which of two colliding keys takes the earlier slot depends
// on the race for the shared-memory CAS, and the order inside a partition
// on the race for the histogram's atomics. The slot layout may differ from
// run to run; the table's invariants (every live key once, with its row;
// every slot between a key's home and its slot occupied) and every probe
// answer do not.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr u64 kEmpty = 0x7FFFFFFFFFFFFFFFULL;
constexpr int kThreads = 256;        // direct probe
constexpr int kCountThreads = 512;   // count; scatter through global atomics
constexpr int kCountPer = 16;        // keys per thread there
constexpr int kCountTile = kCountThreads * kCountPer;
constexpr int kSortThreads = 512;    // the sorting scatter
constexpr int kSortPer = 8;
constexpr int kSortTile = kSortThreads * kSortPer;
constexpr int kCoarseBins = 128;     // its first pass's bins, where P > 128
constexpr int kWideThreads = 1024;   // the wide scatter: one pass of a probe
constexpr int kWidePer = 16;
constexpr int kWideTile = kWideThreads * kWidePer;
constexpr int kWideBins = 2048;      // ... over at most this many slices
constexpr int kSliceThreads = 512;   // insert and answer
constexpr int kInsertPer = 8;        // records per thread per round there
constexpr int kAnswerPer = 16;
constexpr int kScanThreads = 1024;
constexpr int kOverflowThreads = 256;

__device__ __forceinline__ u64 mix64(u64 z) {
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

// The partition of a key: its home slot's slice.
__device__ __forceinline__ unsigned part_of(u64 k, u64 mask, int slice_log2) {
  return (unsigned)((mix64(k) & mask) >> slice_log2);
}

// counts[p] += the live keys of this CTA's tile in partition p.
__global__ void __launch_bounds__(kCountThreads)
part_count_kernel(const u64* __restrict__ keys, long long n, u64 mask,
                  int slice_log2, unsigned parts, int hist_shared,
                  int* __restrict__ counts) {
  extern __shared__ int hist[];
  const long long base = (long long)blockIdx.x * kCountTile + threadIdx.x;
  if (hist_shared) {
    for (unsigned b = threadIdx.x; b < parts; b += kCountThreads) hist[b] = 0;
    __syncthreads();
  }
#pragma unroll 4
  for (int j = 0; j < kCountPer; ++j) {
    const long long i = base + (long long)j * kCountThreads;
    if (i < n) {
      const u64 k = __ldcs(keys + i);
      if (k != kEmpty) {
        const unsigned p = part_of(k, mask, slice_log2);
        if (hist_shared)
          atomicAdd(&hist[p], 1);
        else
          atomicAdd(&counts[p], 1);
      }
    }
  }
  if (hist_shared) {
    __syncthreads();
    for (unsigned b = threadIdx.x; b < parts; b += kCountThreads) {
      const int c = hist[b];
      if (c) atomicAdd(&counts[b], c);
    }
  }
}

// Exclusive scan over the block of one int per thread (every thread calls).
template <int kBlock>
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kBlock / 32 ? warp_sum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kBlock / 32) warp_sum[lane] = w;
  }
  __syncthreads();
  const int r = (warp ? warp_sum[warp - 1] : 0) + x - v;
  __syncthreads();  // warp_sum may be reused
  return r;
}

// offsets[p] = cursor[p] = counts[0] + ... + counts[p - 1], in one CTA;
// coarse[p >> coarse_shift] = offsets[p] at the first p of each coarse
// bin, and *total = the live keys.
__global__ void __launch_bounds__(kScanThreads)
part_scan_kernel(const int* __restrict__ counts, unsigned parts,
                 int coarse_shift, int* __restrict__ offsets,
                 int* __restrict__ cursor, int* __restrict__ coarse,
                 int* __restrict__ total) {
  __shared__ int warp_sum[kScanThreads / 32];
  __shared__ int carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (unsigned base = 0; base < parts; base += kScanThreads) {
    const unsigned i = base + threadIdx.x;
    const int v = i < parts ? counts[i] : 0;
    const int excl = carry + block_exclusive_scan<kScanThreads>(v, warp_sum);
    if (i < parts) {
      offsets[i] = excl;
      cursor[i] = excl;
      if ((i & ((1u << coarse_shift) - 1)) == 0) coarse[i >> coarse_shift] = excl;
    }
    __syncthreads();  // every thread has read carry
    if (threadIdx.x == kScanThreads - 1) carry = excl + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = carry;
}

// (key, row id) of every live key into partition order through one global
// atomic per key, skey/sidx[cursor[p]++]: for tables of more slices than a
// shared-memory histogram holds.
__global__ void __launch_bounds__(kCountThreads)
part_scatter_kernel(const u64* __restrict__ keys, long long n, u64 mask,
                    int slice_log2, int* __restrict__ cursor,
                    u64* __restrict__ skey, int* __restrict__ sidx) {
  const long long base = (long long)blockIdx.x * kCountTile + threadIdx.x;
#pragma unroll 4
  for (int j = 0; j < kCountPer; ++j) {
    const long long i = base + (long long)j * kCountThreads;
    if (i < n) {
      const u64 k = __ldcs(keys + i);
      if (k != kEmpty) {
        const int pos = atomicAdd(&cursor[part_of(k, mask, slice_log2)], 1);
        skey[pos] = k;
        sidx[pos] = (int)i;
      }
    }
  }
}

// Bytes of shared memory of the sorting scatter over `bins` bins.
__host__ __device__ __forceinline__ size_t sort_smem(int bins) {
  return (size_t)kSortTile * (sizeof(u64) + sizeof(int) + sizeof(uint16_t)) +
         (size_t)bins * 2 * sizeof(int);
}

// One pass of the sorting scatter of (key, row id): each CTA sorts a tile
// of 4096 keys by bin (partition >> shift) in shared memory, reserves one
// global range per non-empty bin (one atomic each), and writes each bin's
// run out with consecutive threads on consecutive addresses. kHasIdx: the
// input carries each key's row id (idx_in), else the row id is its
// position. `n_live`, where given, is the input's length on the device.
template <bool kHasIdx>
__global__ void __launch_bounds__(kSortThreads)
part_sort_scatter_kernel(const u64* __restrict__ keys,
                         const int* __restrict__ idx_in, long long n,
                         const int* __restrict__ n_live, u64 mask,
                         int slice_log2, int shift, int bins,
                         int* __restrict__ cursor, u64* __restrict__ out_key,
                         int* __restrict__ out_idx) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sum[kSortThreads / 32];
  __shared__ int live;
  u64* s_key = reinterpret_cast<u64*>(smem);
  int* s_idx = reinterpret_cast<int*>(s_key + kSortTile);
  uint16_t* s_bin = reinterpret_cast<uint16_t*>(s_idx + kSortTile);
  int* hist = reinterpret_cast<int*>(s_bin + kSortTile);
  int* gbase = hist + bins;
  if (n_live) n = *n_live;
  const long long base = (long long)blockIdx.x * kSortTile + threadIdx.x;
  if (base - threadIdx.x >= n) return;
  for (int b = threadIdx.x; b < bins; b += kSortThreads) hist[b] = 0;
  __syncthreads();
  u64 k[kSortPer];
  int id[kSortPer], bin[kSortPer], rank[kSortPer];
#pragma unroll
  for (int j = 0; j < kSortPer; ++j) {
    const long long i = base + (long long)j * kSortThreads;
    k[j] = i < n ? __ldcs(keys + i) : kEmpty;
    id[j] = kHasIdx && i < n ? __ldcs(idx_in + i) : (int)i;
  }
#pragma unroll
  for (int j = 0; j < kSortPer; ++j) {
    rank[j] = -1;
    bin[j] = 0;
    if (k[j] != kEmpty) {
      bin[j] = (int)(part_of(k[j], mask, slice_log2) >> shift);
      rank[j] = atomicAdd(&hist[bin[j]], 1);
    }
  }
  __syncthreads();
  // each thread scans a run of bins: the tile's offset of each bin, and
  // the bin's global range (stored minus that offset)
  const int per = (bins + kSortThreads - 1) / kSortThreads;
  const int lo = min((int)threadIdx.x * per, bins);
  const int hi = min(lo + per, bins);
  int sum = 0;
  for (int b = lo; b < hi; ++b) sum += hist[b];
  int at = block_exclusive_scan<kSortThreads>(sum, warp_sum);
  if (threadIdx.x == kSortThreads - 1) live = at + sum;
  for (int b = lo; b < hi; ++b) {
    const int c = hist[b];
    hist[b] = at;
    if (c) gbase[b] = atomicAdd(&cursor[b], c) - at;
    at += c;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kSortPer; ++j) {
    if (rank[j] < 0) continue;
    const int to = hist[bin[j]] + rank[j];
    s_key[to] = k[j];
    s_idx[to] = id[j];
    s_bin[to] = (uint16_t)bin[j];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < live; j += kSortThreads) {
    const int pos = gbase[s_bin[j]] + j;
    __stcg(out_key + pos, s_key[j]);
    __stcg(out_idx + pos, s_idx[j]);
  }
}

// The probe's scatter, one pass over up to kWideBins slices, with no count
// beforehand: slice p owns `cap` places from p * cap, and fill[p] counts
// the keys claimed there. Each CTA sorts a tile of 16384 probe keys by
// slice in shared memory (runs of 8 keys and more at 2048 slices),
// reserves one range per slice with one global atomic, and writes each
// run out; dest[i], in probe order, is where probe i went, -1 for an
// int64-max probe, or -2 where its slice was full (the gather walks it).
// A thread keeps each key, and its bin and rank packed in one register.
__global__ void __launch_bounds__(kWideThreads, 1)
part_wide_scatter_kernel(const u64* __restrict__ keys, long long n, u64 mask,
                         int slice_log2, int bins, int cap,
                         int* __restrict__ fill, u64* __restrict__ out_key,
                         int* __restrict__ dest) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sum[kWideThreads / 32];
  __shared__ int live;
  u64* s_key = reinterpret_cast<u64*>(smem);
  uint16_t* s_bin = reinterpret_cast<uint16_t*>(s_key + kWideTile);
  int* hist = reinterpret_cast<int*>(s_bin + kWideTile);
  int* gbase = hist + bins;
  const long long base = (long long)blockIdx.x * kWideTile + threadIdx.x;
  for (int b = threadIdx.x; b < bins; b += kWideThreads) hist[b] = 0;
  __syncthreads();
  u64 k[kWidePer];
  unsigned packed[kWidePer];  // rank << 11 | bin, or ~0u: no key
#pragma unroll
  for (int j = 0; j < kWidePer; ++j) {
    const long long i = base + (long long)j * kWideThreads;
    k[j] = i < n ? __ldcs(keys + i) : kEmpty;
    packed[j] = ~0u;
    if (k[j] != kEmpty) {
      const int bin = (int)part_of(k[j], mask, slice_log2);
      packed[j] = (unsigned)atomicAdd(&hist[bin], 1) << 11 | bin;
    }
  }
  __syncthreads();
  // each thread scans a run of bins: the tile's offset of each bin, and
  // the bin's first place in its slice's range, minus that offset
  const int per = (bins + kWideThreads - 1) / kWideThreads;
  const int lo = min((int)threadIdx.x * per, bins);
  const int hi = min(lo + per, bins);
  int sum = 0;
  for (int b = lo; b < hi; ++b) sum += hist[b];
  int at = block_exclusive_scan<kWideThreads>(sum, warp_sum);
  if (threadIdx.x == kWideThreads - 1) live = at + sum;
  for (int b = lo; b < hi; ++b) {
    const int c = hist[b];
    hist[b] = at;
    if (c) gbase[b] = atomicAdd(&fill[b], c) - at;
    at += c;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kWidePer; ++j) {
    const long long i = base + (long long)j * kWideThreads;
    if (i >= n) continue;
    long long to = -1;
    if (packed[j] != ~0u) {
      const int bin = (int)(packed[j] & 2047u);
      const int at_tile = hist[bin] + (int)(packed[j] >> 11);
      s_key[at_tile] = k[j];
      s_bin[at_tile] = (uint16_t)bin;
      const int place = gbase[bin] + at_tile;
      to = place < cap ? (long long)bin * cap + place : -2;
    }
    __stcs(dest + i, (int)to);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < live; j += kWideThreads) {
    const int bin = s_bin[j];
    const int place = gbase[bin] + j;
    if (place < cap) __stcg(out_key + (long long)bin * cap + place, s_key[j]);
  }
}

// One CTA per slice: insert the partition's keys in shared memory, write
// the slice out, defer the keys that ran off the slice's end.
__global__ void __launch_bounds__(kSliceThreads)
build_insert_kernel(const int* __restrict__ counts,
                    const int* __restrict__ offsets, u64* __restrict__ skey,
                    int* __restrict__ srow, int slice_log2,
                    u64* __restrict__ tkey, int* __restrict__ trow,
                    int* __restrict__ deferred) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ndef;
  const int S = 1 << slice_log2;
  u64* sk = reinterpret_cast<u64*>(smem);
  int* sr = reinterpret_cast<int*>(sk + S);
  const unsigned p = blockIdx.x;
  const int cnt = counts[p];
  u64* rk = skey + offsets[p];
  int* rr = srow + offsets[p];
  for (int j = threadIdx.x; j < S; j += kSliceThreads) {
    sk[j] = kEmpty;
    sr[j] = -1;
  }
  if (threadIdx.x == 0) ndef = 0;
  for (int b = 0; b < cnt; b += kSliceThreads * kInsertPer) {
    u64 k[kInsertPer];
    int r[kInsertPer];
#pragma unroll
    for (int j = 0; j < kInsertPer; ++j) {
      const int i = b + j * kSliceThreads + threadIdx.x;
      k[j] = i < cnt ? __ldcs(rk + i) : kEmpty;
      r[j] = i < cnt ? __ldcs(rr + i) : -1;
    }
    // the slice is filled, and this round's records are read before any
    // deferred one is written back (at an index below the rounds read)
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kInsertPer; ++j) {
      if (k[j] == kEmpty) continue;
      int s = (int)(mix64(k[j]) & (u64)(S - 1));
      for (; s < S; ++s) {
        if (atomicCAS(&sk[s], kEmpty, k[j]) == kEmpty) {
          sr[s] = r[j];
          break;
        }
      }
      if (s == S) {
        const int d = atomicAdd(&ndef, 1);
        rk[d] = k[j];
        rr[d] = r[j];
      }
    }
  }
  __syncthreads();
  u64* gk = tkey + ((u64)p << slice_log2);
  int* gr = trow + ((u64)p << slice_log2);
  if (S >= 4) {
    uint4* gk4 = reinterpret_cast<uint4*>(gk);
    uint4* gr4 = reinterpret_cast<uint4*>(gr);
    const uint4* sk4 = reinterpret_cast<const uint4*>(sk);
    const uint4* sr4 = reinterpret_cast<const uint4*>(sr);
    for (int j = threadIdx.x; j < S / 2; j += kSliceThreads) __stcg(gk4 + j, sk4[j]);
    for (int j = threadIdx.x; j < S / 4; j += kSliceThreads) __stcg(gr4 + j, sr4[j]);
  } else {
    for (int j = threadIdx.x; j < S; j += kSliceThreads) {
      gk[j] = sk[j];
      gr[j] = sr[j];
    }
  }
  if (threadIdx.x == 0) deferred[p] = ndef;
}

// The deferred keys, into the global table: one warp per partition, each
// walk from the start of the next slice, wrapping at T - 1 -> 0.
__global__ void __launch_bounds__(kOverflowThreads)
build_overflow_kernel(const int* __restrict__ offsets,
                      const int* __restrict__ deferred, unsigned parts,
                      const u64* __restrict__ skey,
                      const int* __restrict__ srow, int slice_log2, u64 mask,
                      u64* __restrict__ tkey, int* __restrict__ trow) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kOverflowThreads / 32);
  for (long long p = ((long long)blockIdx.x * kOverflowThreads + threadIdx.x) >> 5;
       p < parts; p += warps) {
    const int d = deferred[p];
    for (int j = lane; j < d; j += 32) {
      const u64 k = skey[offsets[p] + j];
      const int r = srow[offsets[p] + j];
      u64 s = ((u64)(p + 1) << slice_log2) & mask;
      while (true) {
        if (atomicCAS(&tkey[s], kEmpty, k) == kEmpty) {
          trow[s] = r;
          break;
        }
        s = (s + 1) & mask;
      }
    }
  }
}

// One thread per probe, walking its chain in global memory.
__global__ void hash_probe_kernel(const u64* __restrict__ tkey,
                                  const int* __restrict__ trow, u64 mask,
                                  const u64* __restrict__ probe, long long m,
                                  int* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    const u64 k = probe[i];
    int row = -1;
    if (k != kEmpty) {
      u64 slot = mix64(k) & mask;
      while (true) {
        const u64 t = __ldg(&tkey[slot]);
        if (t == k) {
          row = __ldg(&trow[slot]);
          break;
        }
        if (t == kEmpty) break;
        slot = (slot + 1) & mask;
      }
    }
    out[i] = row;
  }
}

// Byte offset of the rows after `w` keys in shared memory, 16-aligned.
__host__ __device__ __forceinline__ size_t rows_at(int w) {
  return ((size_t)w * sizeof(u64) + 15) / 16 * 16;
}

// One CTA per slice: the slice and its halo in shared memory, and every
// probe placed in the slice's range answered from there (or, where its
// chain runs past the halo, from global memory): ans[p * cap + i].
__global__ void __launch_bounds__(kSliceThreads)
probe_answer_kernel(const int* __restrict__ fill, int cap,
                    const u64* __restrict__ skey, const u64* __restrict__ tkey,
                    const int* __restrict__ trow, int slice_log2, int halo,
                    u64 mask, int* __restrict__ ans) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = 1 << slice_log2;
  const int W = S + halo;
  u64* sk = reinterpret_cast<u64*>(smem);
  int* sr = reinterpret_cast<int*>(smem + rows_at(W));
  const unsigned p = blockIdx.x;
  const u64 first = (u64)p << slice_log2;
  const int cnt = min(fill[p], cap);
  const u64* rk = skey + (long long)p * cap;
  int* ra = ans + (long long)p * cap;
  if (S >= 4) {
    const uint4* gk4 = reinterpret_cast<const uint4*>(tkey + first);
    const uint4* gr4 = reinterpret_cast<const uint4*>(trow + first);
    uint4* sk4 = reinterpret_cast<uint4*>(sk);
    uint4* sr4 = reinterpret_cast<uint4*>(sr);
    for (int j = threadIdx.x; j < S / 2; j += kSliceThreads) sk4[j] = __ldcs(gk4 + j);
    for (int j = threadIdx.x; j < S / 4; j += kSliceThreads) sr4[j] = __ldcs(gr4 + j);
  } else {
    for (int j = threadIdx.x; j < S; j += kSliceThreads) {
      sk[j] = tkey[first + j];
      sr[j] = trow[first + j];
    }
  }
  for (int j = threadIdx.x; j < halo; j += kSliceThreads) {
    const u64 g = (first + S + j) & mask;
    sk[S + j] = __ldg(tkey + g);
    sr[S + j] = __ldg(trow + g);
  }
  for (int b = 0; b < cnt; b += kSliceThreads * kAnswerPer) {
    u64 k[kAnswerPer];
#pragma unroll
    for (int j = 0; j < kAnswerPer; ++j) {
      const int i = b + j * kSliceThreads + threadIdx.x;
      k[j] = i < cnt ? __ldcs(rk + i) : kEmpty;
    }
    __syncthreads();  // the slice is in shared memory
#pragma unroll
    for (int j = 0; j < kAnswerPer; ++j) {
      if (k[j] == kEmpty) continue;
      int row = -1;
      int s = (int)(mix64(k[j]) & (u64)(S - 1));
      for (; s < W; ++s) {
        const u64 t = sk[s];
        if (t == k[j]) {
          row = sr[s];
          break;
        }
        if (t == kEmpty) break;
      }
      if (s == W) {  // the chain runs past the halo
        u64 g = (first + W) & mask;
        while (true) {
          const u64 t = __ldg(tkey + g);
          if (t == k[j]) {
            row = __ldg(trow + g);
            break;
          }
          if (t == kEmpty) break;
          g = (g + 1) & mask;
        }
      }
      __stcg(ra + b + j * kSliceThreads + threadIdx.x, row);
    }
  }
}

// out[i] = ans[dest[i]]; -1 where dest[i] is -1; and where it is -2 (the
// probe's slice was full) the probe's own walk in global memory. A CTA
// takes the 16384 positions of one tile of the wide scatter: their places
// fall in runs, one per slice, so each run's reads come to this CTA's L1.
__global__ void __launch_bounds__(kWideThreads)
gather_kernel(const int* __restrict__ dest, const int* __restrict__ ans,
              const u64* __restrict__ probe, const u64* __restrict__ tkey,
              const int* __restrict__ trow, u64 mask, long long n,
              int* __restrict__ out) {
  const long long base = (long long)blockIdx.x * kWideTile + threadIdx.x;
  int d[kWidePer];
#pragma unroll
  for (int j = 0; j < kWidePer; ++j) {
    const long long i = base + (long long)j * kWideThreads;
    d[j] = i < n ? __ldcs(dest + i) : -1;
  }
#pragma unroll
  for (int j = 0; j < kWidePer; ++j) {
    const long long i = base + (long long)j * kWideThreads;
    if (i >= n) continue;
    int row = -1;
    if (d[j] >= 0) {
      row = __ldg(ans + d[j]);
    } else if (d[j] == -2) {
      const u64 k = probe[i];
      for (u64 g = mix64(k) & mask;; g = (g + 1) & mask) {
        const u64 t = __ldg(tkey + g);
        if (t == k) {
          row = __ldg(trow + g);
          break;
        }
        if (t == kEmpty) break;
      }
    }
    __stcs(out + i, row);
  }
}

unsigned int grid_for(long long n, int per_block) {
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7FFFFFFFLL) blocks = 0x7FFFFFFFLL;
  return (unsigned int)blocks;
}

// Opt `kernel` in to `bytes` of dynamic shared memory. The 48 KB a launch
// gets without the opt-in covers the kernel's static shared memory too: a
// slice of 4096 slots (48 KB of keys and rows) plus build_insert_kernel's
// `ndef` is over it.
cudaError_t allow_smem(const void* kernel, size_t bytes) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return e;
  if (bytes + a.sharedSizeBytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The int32 scratch of the build: counts, offsets, cursor, one more
// [parts] array (the deferred counts), the coarse cursors, the
// live total.
struct Work {
  int *counts, *offsets, *cursor, *extra, *coarse, *total;
  Work(int* w, unsigned parts)
      : counts(w), offsets(w + parts), cursor(w + 2 * (size_t)parts),
        extra(w + 3 * (size_t)parts), coarse(w + 4 * (size_t)parts),
        total(w + 4 * (size_t)parts + kCoarseBins) {}
};

// The shift from a partition to its coarse bin: 128 coarse bins at most.
int coarse_shift_of(unsigned parts) {
  int log2 = 0;
  while ((1u << log2) < parts) ++log2;
  return log2 > 7 ? log2 - 7 : 0;
}

// Count the live keys of `n` per partition, and scan the counts into
// offsets, cursors, coarse cursors and the live total.
cudaError_t count_partitions(const u64* keys, long long n, u64 mask,
                             int slice_log2, unsigned parts, int hist_shared,
                             const Work& w, cudaStream_t s) {
  cudaError_t e = cudaMemsetAsync(w.counts, 0, parts * sizeof(int), s);
  if (e != cudaSuccess) return e;
  if (n <= 0) return cudaMemsetAsync(w.offsets, 0, parts * sizeof(int), s);
  const size_t hist = hist_shared ? parts * sizeof(int) : 0;
  if ((e = allow_smem((const void*)part_count_kernel, hist)) != cudaSuccess)
    return e;
  part_count_kernel<<<grid_for(n, kCountTile), kCountThreads, hist, s>>>(
      keys, n, mask, slice_log2, parts, hist_shared, w.counts);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  part_scan_kernel<<<1, kScanThreads, 0, s>>>(
      w.counts, parts, coarse_shift_of(parts), w.offsets, w.cursor, w.coarse,
      w.total);
  return cudaGetLastError();
}

// The build's keys with their row ids into partition order (skey/sidx at
// offsets[p] .. offsets[p] + counts[p]): through global atomics where no
// shared-memory histogram holds the slices, else by the sorting scatter,
// in one pass for up to 128 slices, else in two, by coarse bin first into
// tmp_key/tmp_idx.
cudaError_t scatter_build(const u64* keys, long long n, u64 mask,
                          int slice_log2, unsigned parts, int hist_shared,
                          const Work& w, u64* tmp_key, int* tmp_idx,
                          u64* skey, int* sidx, cudaStream_t s) {
  if (n <= 0) return cudaSuccess;
  if (!hist_shared) {
    part_scatter_kernel<<<grid_for(n, kCountTile), kCountThreads, 0, s>>>(
        keys, n, mask, slice_log2, w.cursor, skey, sidx);
    return cudaGetLastError();
  }
  const int shift = coarse_shift_of(parts);
  const unsigned tiles = grid_for(n, kSortTile);
  const size_t fine = sort_smem((int)parts);
  cudaError_t e;
  if ((e = allow_smem((const void*)part_sort_scatter_kernel<false>, fine)) !=
          cudaSuccess ||
      (e = allow_smem((const void*)part_sort_scatter_kernel<true>, fine)) !=
          cudaSuccess)
    return e;
  if (shift == 0) {
    part_sort_scatter_kernel<false><<<tiles, kSortThreads, fine, s>>>(
        keys, nullptr, n, nullptr, mask, slice_log2, 0, (int)parts, w.cursor,
        skey, sidx);
    return cudaGetLastError();
  }
  const int bins = (int)(parts >> shift);
  part_sort_scatter_kernel<false><<<tiles, kSortThreads, sort_smem(bins), s>>>(
      keys, nullptr, n, nullptr, mask, slice_log2, shift, bins, w.coarse,
      tmp_key, tmp_idx);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  part_sort_scatter_kernel<true><<<tiles, kSortThreads, fine, s>>>(
      tmp_key, tmp_idx, n, w.total, mask, slice_log2, 0, (int)parts,
      w.cursor, skey, sidx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// keys [n] int64; tkey [table_size] int64 and trow [table_size] int32, both
// written in full; slices of 2^slice_log2 slots (<= table_size); skey [n]
// int64 and srow [n] int32 scratch; work [4 * parts + 129] int32 scratch,
// whose entries [3 * parts, 4 * parts) come back as the keys deferred per
// slice. hist_shared: a histogram of `parts` bins fits shared memory.
// Returns the first CUDA error, or 0.
int sr_hash_build(const void* keys, long long n, void* tkey, void* trow,
                  long long table_size, int slice_log2, int hist_shared,
                  void* skey, void* srow, void* work, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned parts = (unsigned)(table_size >> slice_log2);
  const u64 mask = (u64)(table_size - 1);
  const Work w((int*)work, parts);
  cudaError_t e = count_partitions((const u64*)keys, n, mask, slice_log2,
                                   parts, hist_shared, w, s);
  // the coarse pass writes into the table (T >= 2N), which the insert
  // then overwrites
  if (e == cudaSuccess)
    e = scatter_build((const u64*)keys, n, mask, slice_log2, parts,
                      hist_shared, w, (u64*)tkey, (int*)trow, (u64*)skey,
                      (int*)srow, s);
  if (e != cudaSuccess) return (int)e;
  const int S = 1 << slice_log2;
  const size_t smem = (size_t)S * (sizeof(u64) + sizeof(int));
  if ((e = allow_smem((const void*)build_insert_kernel, smem)) != cudaSuccess)
    return (int)e;
  build_insert_kernel<<<parts, kSliceThreads, smem, s>>>(
      w.counts, w.offsets, (u64*)skey, (int*)srow, slice_log2, (u64*)tkey,
      (int*)trow, w.extra);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  long long blocks = ((long long)parts + kOverflowThreads / 32 - 1) /
                     (kOverflowThreads / 32);
  if (blocks > 1024) blocks = 1024;
  build_overflow_kernel<<<(unsigned)blocks, kOverflowThreads, 0, s>>>(
      w.offsets, w.extra, parts, (const u64*)skey, (const int*)srow,
      slice_log2, mask, (u64*)tkey, (int*)trow);
  return (int)cudaGetLastError();
}

// The direct route: tkey/trow [table_size] from sr_hash_build; probe [m]
// int64; out [m] int32.
int sr_hash_probe(const void* tkey, const void* trow, long long table_size,
                  const void* probe, long long m, void* out, void* stream) {
  if (m > 0) {
    hash_probe_kernel<<<grid_for(m, kThreads), kThreads, 0,
                        (cudaStream_t)stream>>>(
        (const u64*)tkey, (const int*)trow, (u64)(table_size - 1),
        (const u64*)probe, m, (int*)out);
  }
  return (int)cudaGetLastError();
}

// The partitioned route: as sr_hash_probe, with slices of 2^slice_log2
// slots (at most kWideBins of them), a halo of `halo` slots, and `cap`
// places a slice for its probes (more go to the gather's own walk); skey
// [parts * cap] int64, sints [m + parts * cap] int32 and fill [parts]
// int32 scratch.
int sr_hash_probe_partitioned(const void* tkey, const void* trow,
                              long long table_size, const void* probe,
                              long long m, void* out, int slice_log2,
                              int halo, int cap, void* skey, void* sints,
                              void* fill, void* stream) {
  if (m <= 0) return 0;
  const unsigned parts = (unsigned)(table_size >> slice_log2);
  if (parts > (unsigned)kWideBins || cap <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const u64 mask = (u64)(table_size - 1);
  int* dest = (int*)sints;  // where each probe went
  int* ans = dest + m;      // the answers, by slice
  cudaError_t e = cudaMemsetAsync(fill, 0, parts * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  const size_t wide = (size_t)kWideTile * (sizeof(u64) + sizeof(uint16_t)) +
                      (size_t)parts * 2 * sizeof(int);
  if ((e = allow_smem((const void*)part_wide_scatter_kernel, wide)) !=
      cudaSuccess)
    return (int)e;
  part_wide_scatter_kernel<<<grid_for(m, kWideTile), kWideThreads, wide, s>>>(
      (const u64*)probe, m, mask, slice_log2, (int)parts, cap, (int*)fill,
      (u64*)skey, dest);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int W = (1 << slice_log2) + halo;
  const size_t smem = rows_at(W) + (size_t)W * sizeof(int);
  if ((e = allow_smem((const void*)probe_answer_kernel, smem)) != cudaSuccess)
    return (int)e;
  probe_answer_kernel<<<parts, kSliceThreads, smem, s>>>(
      (const int*)fill, cap, (const u64*)skey, (const u64*)tkey,
      (const int*)trow, slice_log2, halo, mask, ans);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  gather_kernel<<<grid_for(m, kWideTile), kWideThreads, 0, s>>>(
      dest, ans, (const u64*)probe, (const u64*)tkey, (const int*)trow, mask,
      m, (int*)out);
  return (int)cudaGetLastError();
}

const char* sr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
