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
