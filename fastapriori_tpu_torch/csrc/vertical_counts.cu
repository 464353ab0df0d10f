// K3 on Hopper: the vertical (Eclat) engine's level-k support count by
// lane-wise AND + popcount.
//
// Replaces the Pallas TPU kernel fastapriori_tpu/ops/pallas_vertical.py
// `_vertical_kernel` (launched through `vertical_counts_pallas`):
//
//   count[c] = sum_b 2^b * popcount(AND_k arena[pc[row, k]] & arena[y]
//                                   & planes[b])
//
// summed over all NL lanes, for each flat candidate c = row * f_pad + y.
// arena [f_pad + 1, NL] holds each item's tids packed 32 to a 32-bit lane
// (row f_pad is all ones, the AND identity); planes [B, NL] are the
// weight bit-planes (bit b of each transaction's multiplicity);
// lane_mask [NL] has bit b set where planes[b] is non-zero in that lane
// (derived once per planes upload, ops/vertical_kernel.py);
// pc [P, K] int32 are the prefix rows, where an entry equal to f_pad - 1
// (the all-zero column) means "no item" and ANDs as row f_pad;
// cand [C] int32.  Output [C] int32, zeroed by the caller; warps add
// their partial counts with integer atomics, so the result is exact and
// independent of the order the work runs in.
//
// The caller's contract (device-side asserts here, a ValueError in
// ops/vertical_kernel.py for CPU tensors): prefix entries lie in
// [0, f_pad], and candidates come in whole runs per prefix row, as
// models/apriori.py `level_chunks` yields them.  A first pass writes each
// row's run as start[row] .. start[row + 1] (asserting that rows do not
// decrease); the counting pass asserts that each candidate's row is the
// row whose run holds it.
//
// What bounds it on the H100, and what the design does about it:
// - The dense sweep (every candidate x lane x plane, the TPU kernel's
//   form) is B popcounts per (candidate, lane): 9.6 G at the kosarak
//   shape's level 3.  The data need far fewer.  At that launch 79 % of the
//   prefix-AND words are zero, 95.5 % of the intersection words, and the
//   upper planes are zero in most lanes (2.09 non-zero plane words per
//   lane out of 11).  So the work is skipped where the data are zero:
//   * a warp owns one (prefix row, 512-lane chunk) item at a time.  It
//     ANDs the row's prefix lanes once (K coalesced loads per lane) and
//     compacts the non-zero words, with their lane indexes, into its own
//     shared-memory list (ballot + prefix count);
//   * it then sweeps the row's candidates four at a time over that list
//     only: one extension load per (candidate, listed lane), so the
//     extension row is never read where the prefix is zero and the prefix
//     AND stays in shared memory across the row's candidates;
//   * only where an intersection word is non-zero are plane words read,
//     and only the planes that lane_mask names (the four candidates share
//     each plane load).
//   What is left is the extension loads (gathered from L2: the arena of
//   a few tens of MB stays in the 50 MB L2) and the per-list-entry
//   issue work; popcounts fall to the non-zero (intersection, plane)
//   word pairs.
// - The grid is persistent: one wave of blocks whose warps take items
//   from a counter in (lane chunk, row) order, so rows without candidates
//   cost a check and no block, long rows do not hold up a wave, and warps
//   running together share a lane chunk of the arena and planes in L1.
// - Ragged NL, P and C are masked; nothing needs to divide a tile.
//
// Beside K3, the same library builds K3's input: the tid-lane arena from
// the basket CSR (fa_build_arena; it replaces a host sort and reduce and
// its upload, and no TPU kernel: the JAX package builds the arena on the
// host).  For each
// transaction t and each item i of it, bit t % 32 of arena[i, t / 32] is
// set; the item rows are zero elsewhere and row f_pad is all ones.
// What bounds it: the CSR read once (4 bytes an item, 8 a basket) and the
// arena written once, some 27 MB at the T20 cell's shape, 8 us at
// 3.35 TB/s.  The design:
// - a fill kernel writes the arena's zero rows and its all-ones row in
//   one coalesced pass;
// - in the scatter kernel a warp owns one lane word, its 32 consecutive
//   transactions, one a lane, so no other warp writes that column of the
//   arena.  Each lane walks its basket's items in order (the ingest sorts
//   them); at each step the warp takes the least current item
//   (__reduce_min_sync), the lanes holding it (a ballot) are exactly the
//   word's bits for that item, and one lane ORs them into global memory
//   with one atomic; those lanes move on.  So a word costs one atomic
//   per distinct item in it, not one per (basket, item) pair, and the
//   result does not depend on the order in which warps run.

#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLC = 512;              // lanes per work item
constexpr int kWordsPerLane = kLC / 32;
constexpr int kCand = 4;              // candidates swept together
constexpr int kMaxPlanes = 31;        // weights below 2^31

// start[r] = the first candidate whose row is >= r, for r in [0, P]; the
// work counter is zeroed here too.
__global__ void run_starts_kernel(const int32_t* __restrict__ cand,
                                  int32_t* __restrict__ start,
                                  unsigned long long* __restrict__ counter,
                                  int f_pad, int P, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c == 0) *counter = 0;
  if (c > C) return;
  int r = P;
  if (c < C) {
    const int ix = cand[c];
    assert(ix >= 0 && ix / f_pad < P);
    r = ix / f_pad;
  }
  int prev = -1;
  if (c > 0) prev = cand[c - 1] / f_pad;
  assert(prev <= r);  // whole runs per row
  for (int q = prev + 1; q <= r; ++q) start[q] = c;
}

__global__ void __launch_bounds__(kThreads)
vertical_counts_kernel(const uint32_t* __restrict__ arena,
                       const uint32_t* __restrict__ planes,
                       const uint32_t* __restrict__ lane_mask,
                       const int32_t* __restrict__ pc,
                       const int32_t* __restrict__ cand,
                       const int32_t* __restrict__ start,
                       unsigned long long* __restrict__ counter,
                       int32_t* out, int f_pad, int NL, int P, int K,
                       unsigned long long items) {
  __shared__ uint32_t list_word[kWarps][kLC];
  __shared__ int32_t list_lane[kWarps][kLC];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint32_t* lw = list_word[warp];
  int32_t* ll = list_lane[warp];
  const unsigned below = (1u << lane) - 1u;

  unsigned long long item = 0;
  if (lane == 0) item = atomicAdd(counter, 1ull);
  item = __shfl_sync(kFull, item, 0);
  while (item < items) {
    // Take the next item now, so its counter round trip overlaps this
    // one's work.
    unsigned long long next = 0;
    if (lane == 0) next = atomicAdd(counter, 1ull);
    const int row = (int)(item % P);
    const int chunk = (int)(item / P);
    const int c0 = start[row];
    const int c1 = start[row + 1];
    if (c0 < c1) {
      // The row's prefix AND over this chunk, compacted to its non-zero
      // words.
      const int l0 = chunk * kLC;
      uint32_t acc[kWordsPerLane];
#pragma unroll
      for (int j = 0; j < kWordsPerLane; ++j) acc[j] = kFull;
      for (int k = 0; k < K; ++k) {
        int col = pc[(size_t)row * K + k];
        assert(col >= 0 && col <= f_pad);
        col = col == f_pad - 1 ? f_pad : col;
        const uint32_t* src = arena + (size_t)col * NL;
#pragma unroll
        for (int j = 0; j < kWordsPerLane; ++j) {
          const int l = l0 + 32 * j + lane;
          acc[j] &= l < NL ? __ldg(src + l) : 0u;
        }
      }
      int n = 0;
#pragma unroll
      for (int j = 0; j < kWordsPerLane; ++j) {
        const unsigned bal = __ballot_sync(kFull, acc[j] != 0);
        if (acc[j] != 0) {
          const int at = n + __popc(bal & below);
          lw[at] = acc[j];
          ll[at] = l0 + 32 * j + lane;
        }
        n += __popc(bal);
      }
      __syncwarp();

      for (int c = c0; n > 0 && c < c1; c += kCand) {
        const uint32_t* ext[kCand];
        unsigned sum[kCand];
#pragma unroll
        for (int u = 0; u < kCand; ++u) {
          const int cc = c + u < c1 ? c + u : c;
          const int ix = cand[cc];
          assert(ix >= 0 && ix / f_pad == row);
          ext[u] = arena + (size_t)(ix - row * f_pad) * NL;
          sum[u] = 0;
        }
        for (int i = lane; i < n; i += 32) {
          const int l = ll[i];
          const uint32_t w = lw[i];
          uint32_t x[kCand];
          uint32_t any = 0;
#pragma unroll
          for (int u = 0; u < kCand; ++u) {
            x[u] = w & __ldg(ext[u] + l);
            any |= x[u];
          }
          if (any) {
            // Only the planes that are non-zero in this lane.  Unsigned:
            // every partial sum is at most the weighted count, which the
            // caller keeps below 2^31.
            uint32_t m = __ldg(lane_mask + l);
            while (m) {
              const int b = __ffs(m) - 1;
              m &= m - 1;
              const uint32_t p = __ldg(planes + (size_t)b * NL + l);
#pragma unroll
              for (int u = 0; u < kCand; ++u)
                sum[u] += (unsigned)__popc(x[u] & p) << b;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kCand; ++u) {
          const unsigned s = __reduce_add_sync(kFull, sum[u]);
          if (lane == 0 && s != 0 && c + u < c1)
            atomicAdd(out + c + u, (int32_t)s);
        }
      }
      __syncwarp();  // the list is rewritten by the next item
    }
    item = __shfl_sync(kFull, next, 0);
  }
}

constexpr int kBuildThreads = 256;
constexpr int kBuildWarps = kBuildThreads / 32;
constexpr int kNoItem = 0x7fffffff;   // a finished lane's item

// arena[0 .. f_pad * NL) = 0, arena[f_pad * NL .. (f_pad + 1) * NL) = ~0.
__global__ void arena_fill_kernel(uint32_t* __restrict__ arena,
                                  size_t zero_words, size_t words) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t w = (size_t)blockIdx.x * blockDim.x + threadIdx.x; w < words;
       w += stride)
    arena[w] = w < zero_words ? 0u : kFull;
}

// Warp w sets the bits of lane word w: lane j holds transaction 32 w + j.
__global__ void __launch_bounds__(kBuildThreads)
arena_scatter_kernel(const int32_t* __restrict__ indices,
                     const int64_t* __restrict__ offsets,
                     uint32_t* arena, int T, int NL, int num_items) {
  const int word = (int)(((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (word >= NL) return;  // whole warps: NL is uniform across the warp
  const int t = word * 32 + lane;
  int64_t p = 0, end = 0;
  if (t < T) {
    p = offsets[t];
    end = offsets[t + 1];
  }
  int cur = p < end ? __ldg(indices + p) : kNoItem;
  for (;;) {
    const int least = __reduce_min_sync(kFull, cur);
    if (least == kNoItem) break;
    const unsigned bits = __ballot_sync(kFull, cur == least);
    if (cur == least) {
      if (lane == __ffs(bits) - 1) {
        assert(least >= 0 && least < num_items);
        atomicOr(arena + (size_t)least * NL + word, bits);
      }
      ++p;
      cur = p < end ? __ldg(indices + p) : kNoItem;
    }
  }
}

}  // namespace

// scratch: P + 3 int32, 8-byte aligned (the work counter, then the run
// starts).  Launches on `stream`
// and returns cudaGetLastError() (0 = launched).
extern "C" int fa_vertical_counts(const void* arena, const void* planes,
                                  const void* lane_mask, const void* pc,
                                  const void* cand, void* scratch, void* out,
                                  int f_pad, int NL, int B, int P, int K,
                                  int C, void* stream) {
  if (C <= 0 || NL <= 0 || P <= 0) return 0;
  if (B < 1 || B > kMaxPlanes || K < 1 || f_pad < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* counter = (unsigned long long*)scratch;
  int32_t* start = (int32_t*)(counter + 1);
  run_starts_kernel<<<(C + 1 + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      (const int32_t*)cand, start, counter, f_pad, P, C);
  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, vertical_counts_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long items =
      (unsigned long long)P * ((NL + kLC - 1) / kLC);
  unsigned long long blocks = (unsigned long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned long long need = (items + kWarps - 1) / kWarps;
  if (blocks > need) blocks = need;
  vertical_counts_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      (const uint32_t*)arena, (const uint32_t*)planes,
      (const uint32_t*)lane_mask, (const int32_t*)pc, (const int32_t*)cand,
      start, counter, (int32_t*)out, f_pad, NL, P, K, items);
  return (int)cudaGetLastError();
}

// The tid-lane arena [f_pad + 1, NL] (uint32 words) from the basket CSR:
// indices [offsets[T]] int32 item ids in [0, num_items), ascending within
// each basket for one atomic per (item, word); offsets [T + 1] int64.
// Needs num_items < f_pad and T <= 32 NL.  Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int fa_build_arena(const void* indices, const void* offsets,
                              void* arena, int T, int num_items, int f_pad,
                              int NL, void* stream) {
  if (T < 0 || NL < 0 || num_items < 0 || f_pad <= num_items ||
      (long long)T > 32LL * NL)
    return (int)cudaErrorInvalidValue;
  if (NL == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t zero_words = (size_t)f_pad * NL;
  const size_t words = zero_words + NL;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  size_t fill_blocks = (words + kBuildThreads - 1) / kBuildThreads;
  if (fill_blocks > (size_t)sms * 16) fill_blocks = (size_t)sms * 16;
  arena_fill_kernel<<<(unsigned)fill_blocks, kBuildThreads, 0, st>>>(
      (uint32_t*)arena, zero_words, words);
  if (T > 0) {
    const int words_with_bits = (T + 31) / 32;
    arena_scatter_kernel<<<(words_with_bits + kBuildWarps - 1) / kBuildWarps,
                           kBuildThreads, 0, st>>>(
        (const int32_t*)indices, (const int64_t*)offsets, (uint32_t*)arena,
        T, NL, num_items);
  }
  return (int)cudaGetLastError();
}
