// Lower-bound search of join probe keys in the sorted build keys.
//
// Replaces the TPU kernel probe_searchsorted_pallas (starrocks_tpu/ops/
// pallas_kernels.py:316, body _probe_block_kernel :295). Contract, as there:
// `build` [k] int64 sorted ascending (NULL/dead rows carry the int64-max
// sentinel and sort last), `probe` [n] int64; pos[i] is the first index j
// with build[j] >= probe[i] (k when there is none), as int32 — that is
// searchsorted(build, probe, side='left'). The TPU kernel keeps the whole
// build in VMEM and runs a branch-free halving ladder over a probe block.
//
// What bounds it on an H100: bytes — n * 12 (key in, position out) plus
// the build's k * 8 read once. A plain binary search instead makes
// ceil(log2(k + 1)) dependent loads at data-dependent addresses; at the
// main path's shape (k = 8M keys, 64 MB, more than the 50 MB L2) its lower
// levels wait on DRAM one after another.
//
// Design: a static search tree over the build, built by the caller in
// each call (ops/kernels.probe_index: one strided copy per level, which
// reads the build once). The leaves are the build itself, left in place:
// groups of 4 keys (one 32-byte sector). Level 1 holds every group's last
// key (entry j = build[4j + 3]), level 2 every 16th of those
// (build[64j + 63]), and so on, 16 entries (one 128-byte line) per node,
// until a level has at most 2048 entries (16 KB); that top level is copied
// into each CTA's shared memory. Positions past k read as int64-max, and
// every level is padded with it to whole nodes. At k = 8,000,512: levels
// of 2,000,128 (16 MB), 125,008 (1 MB) and 7,813 (62.5 KB) entries, and a
// top of 489. Per probe: a binary search of the top level in shared
// memory, then one node per lower level, then one sector of the build —
// against some 23 dependent loads of a binary search.
//
// What bounds this design: not the bytes but the lines it touches and the
// warp collectives that share them out. Per probe it reads one 128-byte
// line per inner level and one sector of the build, and the load/store
// unit looks up each line separately, so a warp reads cooperatively (see
// probe_tree_kernel): one load instruction serves 4 probes' nodes instead
// of one probe's eighth. The price is the shuffles and ballots around each
// batch, about 4 per probe at k = 8M. The build's sectors, the probe keys and the positions go through with
// streaming hints (evict-first), so that they leave the 17 MB of inner
// levels in L2.
//
// Invariant at each level: the probe descends to the first entry >= key.
// Every earlier entry is the last key of a range wholly below the key, and
// the chosen entry is the last key of its range, so the answer lies inside
// that range even where a run of equal keys crosses node boundaries. A top
// search that finds no entry >= key means every key is below it: k. The
// result is clamped to k.
//
// The grid is persistent: at most as many CTAs as fit on the card at
// once, each loading the top level once and walking many probes with a
// grid-stride loop.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kLeaf = 4;     // keys per leaf group
constexpr int kNode = 16;    // entries per inner node
// lanes that read one node or leaf group together, 16 bytes each, and the
// probes one load instruction serves
constexpr int kNodeLanes = kNode / 2;
constexpr int kNodesPerLoad = 32 / kNodeLanes;
constexpr int kLeafLanes = kLeaf / 2;
constexpr int kLeavesPerLoad = 32 / kLeafLanes;
constexpr int kMaxLevels = 8;
constexpr long long kI64Max = 0x7fffffffffffffffLL;

struct Levels {
  long long off[kMaxLevels];  // offset of each level in the index, bottom first
  int count;                  // levels; the last one is the top
  int top_n;                  // real (unpadded) entries of the top level
};

// One warp takes 32 probes, one a lane, and each lane searches the top
// level for its own probe. The lower levels are read cooperatively, so
// that one load instruction touches few lines: in each of 8 batches, 4
// probes' nodes (128 bytes) are read by 8 lanes each, 16 bytes a lane;
// then 16 probes' leaf groups (32 bytes) by 2 lanes each, twice. The
// batch's keys and nodes come by shuffle, ballots count the entries below
// each key, and the lane whose probe it is keeps its count.
__global__ void __launch_bounds__(kThreads)
probe_tree_kernel(const long long* __restrict__ build, long long k,
                  const long long* __restrict__ probe, long long n,
                  const long long* __restrict__ index, Levels lv,
                  int* __restrict__ pos) {
  extern __shared__ long long top[];
  const long long* top_src = index + lv.off[lv.count - 1];
  for (int j = threadIdx.x; j < lv.top_n; j += kThreads) top[j] = top_src[j];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const bool leaf_vec = (reinterpret_cast<uintptr_t>(build) & 15) == 0;
  const long long stride = (long long)gridDim.x * kThreads;
  // the loop is warp-uniform: every lane runs every shuffle and ballot
  for (long long base = (long long)blockIdx.x * kThreads + (threadIdx.x & ~31);
       base < n; base += stride) {
    const long long i = base + lane;
    const bool live = i < n;
    long long key = live ? __ldcs(probe + i) : kI64Max;
    int lo = 0, hi = lv.top_n;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (top[mid] < key) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    // every key is below the probe: the answer is k. Such a lane descends
    // node 0 with the smallest key, reading in bounds and counting nothing
    const bool past = lo == lv.top_n;
    if (past) key = LLONG_MIN;
    int node = past ? 0 : lo;
    for (int l = lv.count - 2; l >= 0; --l) {
      const longlong2* level =
          reinterpret_cast<const longlong2*>(index + lv.off[l]);
      int below = 0;
#pragma unroll
      for (int b = 0; b < kNodeLanes; ++b) {  // kNodesPerLoad probes a load
        const int p = b * kNodesPerLoad + lane / kNodeLanes;
        const int nd = __shfl_sync(kFull, node, p);
        const long long kk = __shfl_sync(kFull, key, p);
        const longlong2 q =
            __ldg(level + nd * kNodeLanes + lane % kNodeLanes);
        const unsigned bx = __ballot_sync(kFull, q.x < kk);
        const unsigned by = __ballot_sync(kFull, q.y < kk);
        if (lane / kNodesPerLoad == b) {
          const unsigned m = ((1u << kNodeLanes) - 1)
                             << (kNodeLanes * (lane % kNodesPerLoad));
          below = __popc(bx & m) + __popc(by & m);
        }
      }
      node = node * kNode + below;
    }
    int below = 0;
#pragma unroll
    for (int b = 0; b < kLeafLanes; ++b) {  // kLeavesPerLoad probes a load
      const int p = b * kLeavesPerLoad + lane / kLeafLanes;
      const long long first = (long long)__shfl_sync(kFull, node, p) * kLeaf;
      const long long kk = __shfl_sync(kFull, key, p);
      const long long at = first + 2 * (lane % kLeafLanes);
      long long x, y;
      if (leaf_vec && first + kLeaf <= k) {
        const longlong2 q =
            __ldcs(reinterpret_cast<const longlong2*>(build + at));
        x = q.x;
        y = q.y;
      } else {
        x = at < k ? __ldcs(build + at) : kI64Max;
        y = at + 1 < k ? __ldcs(build + at + 1) : kI64Max;
      }
      const unsigned bx = __ballot_sync(kFull, x < kk);
      const unsigned by = __ballot_sync(kFull, y < kk);
      if (lane / kLeavesPerLoad == b) {
        const unsigned m = ((1u << kLeafLanes) - 1)
                           << (kLeafLanes * (lane % kLeavesPerLoad));
        below = __popc(bx & m) + __popc(by & m);
      }
    }
    if (live) {
      const long long first = (long long)node * kLeaf;
      __stcs(pos + i, past ? (int)k : (int)min(first + below, k));
    }
  }
}

}  // namespace

extern "C" {

// build [k] int64 sorted, probe [n] int64, pos [n] int32; k < 2^31.
// index: the levels of ops/kernels.probe_index, bottom first, at the int64
// offsets `level_off` (a host array of `levels` entries); the top level has
// `top_n` entries. Returns cudaGetLastError().
int sr_probe_searchsorted(const void* build, long long k, const void* probe,
                          long long n, void* pos, const void* index,
                          const long long* level_off, int levels, int top_n,
                          void* stream) {
  if (n <= 0 || k <= 0) return 0;
  if (levels < 1 || levels > kMaxLevels || top_n < 1)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int l = 0; l < levels; ++l) lv.off[l] = level_off[l];
  lv.count = levels;
  lv.top_n = top_n;
  const size_t smem = (size_t)top_n * sizeof(long long);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(probe_tree_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, probe_tree_kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const long long need = (n + kThreads - 1) / kThreads;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > need) blocks = need;
  probe_tree_kernel<<<(unsigned int)blocks, kThreads, smem,
                      (cudaStream_t)stream>>>(
      (const long long*)build, k, (const long long*)probe, n,
      (const long long*)index, lv, (int*)pos);
  return (int)cudaGetLastError();
}

const char* sr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
