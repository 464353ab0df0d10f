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
// pc [P, K] int32 are the prefix rows, where an entry equal to f_pad - 1
// (the all-zero column) means "no item" and ANDs as row f_pad;
// cand [C] int32.  Output [C] int32, zeroed by the caller; blocks add
// their partial counts with integer atomics, so the result is exact and
// independent of block order.
//
// The caller's contract (a device-side assert here, a ValueError in
// ops/vertical_kernel.py for CPU tensors): prefix entries lie in
// [0, f_pad], and candidates come in whole runs per prefix row, as
// models/apriori.py `level_chunks` yields them.  The wrapper passes each
// row's run as start[row] .. start[row + 1]; the starts rise from 0 to C,
// so every candidate is read by exactly one block, which asserts that the
// candidate's row is its own.
//
// What bounds it on the H100, and what the design does about it:
// - The work is integer operations: per candidate and lane one AND with
//   the extension row, then per plane one AND and one population count.
//   The count runs at a quarter of the AND rate (16 against 64 per clock
//   and SM), so B popcounts per (candidate, lane) bound the kernel.  The
//   bytes are small beside them: the arena (a few tens of MB at the
//   kosarak shape) stays in the 50 MB L2 across blocks.
// - The TPU kernel swept (lane tiles, candidate tiles) in order and kept
//   a [P, lane tile] prefix-AND scratch resident across the candidate
//   sweep.  Blocks run in no order here, so the grid is (prefix row,
//   lane tile): a block ANDs its row's prefix lanes for one tile of kLT
//   lanes once, into shared memory beside that tile of the B planes, and
//   then its warps sweep the row's candidates, one candidate per warp at
//   a time, with coalesced loads of the extension row.  A warp reduces its
//   count with one shuffle reduction and adds it to the output with one
//   atomic; the lane tiles of a candidate add up there.  Rows without
//   candidates (the pow2 padding of the prefix axis) return at once.
// - Ragged NL, P and C are masked; nothing needs to divide a tile.

#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLT = 1024;        // lanes per lane tile
constexpr int kMaxPlanes = 31;   // weights below 2^31

__global__ void __launch_bounds__(kThreads)
vertical_counts_kernel(const uint32_t* __restrict__ arena,
                       const uint32_t* __restrict__ planes,
                       const int32_t* __restrict__ pc,
                       const int32_t* __restrict__ cand,
                       const int32_t* __restrict__ start,
                       int32_t* out, int f_pad, int NL, int B, int K) {
  extern __shared__ uint32_t smem[];  // [1 + B][kLT]: prefix AND, planes
  const int row = blockIdx.x;
  const int c0 = start[row];
  const int c1 = start[row + 1];
  if (c0 >= c1) return;
  const int l0 = blockIdx.y * kLT;
  const int nl = min(kLT, NL - l0);
  uint32_t* pref = smem;
  uint32_t* pl = smem + kLT;

  const int32_t* cols = pc + (size_t)row * K;
  for (int l = threadIdx.x; l < nl; l += kThreads) {
    uint32_t acc = kFull;
    for (int k = 0; k < K; ++k) {
      int c = cols[k];
      assert(c >= 0 && c <= f_pad);
      c = c == f_pad - 1 ? f_pad : c;
      acc &= arena[(size_t)c * NL + l0 + l];
    }
    pref[l] = acc;
    for (int b = 0; b < B; ++b)
      pl[b * kLT + l] = planes[(size_t)b * NL + l0 + l];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int c = c0 + warp; c < c1; c += kWarps) {
    const int ix = cand[c];
    const int r = ix / f_pad;
    assert(ix >= 0 && r == row);
    const uint32_t* ext = arena + (size_t)(ix - r * f_pad) * NL + l0;
    // Unsigned: every partial sum is at most the weighted count, which
    // the caller keeps below 2^31; wrapping would match the plain version.
    unsigned sum = 0;
    for (int l = lane; l < nl; l += 32) {
      const uint32_t x = pref[l] & __ldg(ext + l);
      for (int b = 0; b < B; ++b)
        sum += (unsigned)__popc(x & pl[b * kLT + l]) << b;
    }
    sum = __reduce_add_sync(kFull, sum);
    if (lane == 0 && sum != 0) atomicAdd(out + c, (int32_t)sum);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int fa_vertical_counts(const void* arena, const void* planes,
                                  const void* pc, const void* cand,
                                  const void* start, void* out, int f_pad,
                                  int NL, int B, int P, int K, int C,
                                  void* stream) {
  if (C <= 0 || NL <= 0 || P <= 0) return 0;
  if (B < 1 || B > kMaxPlanes || K < 1 || f_pad < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(1 + B) * kLT * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      vertical_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(P, (NL + kLT - 1) / kLT);
  vertical_counts_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)arena, (const uint32_t*)planes, (const int32_t*)pc,
      (const int32_t*)cand, (const int32_t*)start, (int32_t*)out, f_pad, NL,
      B, K);
  return (int)cudaGetLastError();
}
