// K2 on Hopper: first-match recommend scan over the priority-sorted rule
// table.
//
// Replaces the Pallas TPU kernel fastapriori_tpu/ops/pallas_vertical.py
// `_match_kernel` (launched through `strided_best_rank_pallas`), at one
// shard, where a rule's global rank is its row:
//
//   best[b] = min { r : sum_k baskets[b, ant[r, k]] == size[r],
//                       size[r] <= len[b], baskets[b, cons[r]] == 0 }
//
// or NO_MATCH = 2^31 - 1 when no rule fires.  baskets [MB, F] int8,
// len [MB] int32, ant [R, K] int32 (padding positions point at an
// all-zero column), size/cons [R] int32 (padding rules have size > F).
// `best` is filled with NO_MATCH by the caller; blocks lower it with
// atomicMin, so the result is exact in any block order.
//
// What bounds it on the H100, and what the design does about it:
// - The work is a gather: per (basket, rule) pair, K byte lookups and
//   two compares.  The TPU kernel swept every rule tile with no early
//   exit; the minimum over all rules equals the first match because rank
//   grows along the table, and the same fact lets this kernel stop early
//   without changing the answer.
// - A block holds 32 baskets, transposed in shared memory ([F][32] bytes:
//   one lane per basket, so a lookup of one column by the 32 lanes is one
//   conflict-free 32-byte row).  Its 8 warps walk one rule range in rank
//   order, all lanes on the same rule, so rule loads are warp-uniform
//   broadcasts.  A lane stops at its first match (later rules of the warp
//   have larger ranks), a warp stops when every lane has matched, rules
//   whose size or consequent rule out every lane are skipped before any
//   gather, and a block whose baskets all matched in an earlier rule range
//   returns at once.  What is left is bound by shared-memory lookups.
// - The consequent is selected outside the kernel (ops/contain.py), as the
//   reference's `_strided_merge` does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBT = 32;                // baskets per block: one per lane
constexpr int kRulesPerBlock = 2048;   // rule range per block
constexpr int kMaxF = 7168;            // [F][32] bytes of shared memory
constexpr int32_t kNoMatch = 0x7fffffff;

__global__ void __launch_bounds__(kThreads)
first_match_kernel(const int8_t* __restrict__ baskets,
                   const int32_t* __restrict__ blen,
                   const int32_t* __restrict__ ant,
                   const int32_t* __restrict__ size,
                   const int32_t* __restrict__ cons,
                   int32_t* best, int MB, int F, int R, int K) {
  extern __shared__ int8_t tile[];  // [F][kBT]
  __shared__ int32_t lane_best[kBT];
  __shared__ int skip;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b0 = blockIdx.x * kBT;
  const int b = b0 + lane;
  const bool real = b < MB;
  const int r_begin = blockIdx.y * kRulesPerBlock;
  const int r_end = min(R, r_begin + kRulesPerBlock);

  if (warp == 0) {
    // An earlier rule range already matched every basket of the tile:
    // nothing in this range can lower their minimum.
    const int cur = real ? ((volatile const int32_t*)best)[b] : 0;
    const bool settled = !real || cur < r_begin;
    const bool all = __all_sync(kFull, settled);
    if (lane == 0) skip = all;
    lane_best[lane] = kNoMatch;
  }
  __syncthreads();
  if (skip) return;

  for (int i = tid; i < kBT * F; i += kThreads) {
    const int j = i / F;
    const int c = i - j * F;
    tile[c * kBT + j] = b0 + j < MB ? baskets[(size_t)(b0 + j) * F + c] : 0;
  }
  __syncthreads();

  const int len = real ? blen[b] : 0;
  int mine = kNoMatch;
  bool done = !real;
  for (int r = r_begin + warp; r < r_end; r += kWarps) {
    if (__all_sync(kFull, done)) break;
    const int sz = size[r];
    bool cand = !done && sz <= len;
    if (!__any_sync(kFull, cand)) continue;
    cand = cand && tile[cons[r] * kBT + lane] == 0;
    if (!__any_sync(kFull, cand)) continue;
    const int32_t* a = ant + (size_t)r * K;
    int ov = 0;
    for (int k = 0; k < K; ++k) ov += tile[a[k] * kBT + lane];
    if (cand && ov == sz) {
      mine = r;
      done = true;
    }
  }
  atomicMin(&lane_best[lane], mine);
  __syncthreads();
  if (warp == 0 && real && lane_best[lane] != kNoMatch)
    atomicMin(best + b, lane_best[lane]);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int fa_first_match(const void* baskets, const void* blen,
                              const void* ant, const void* size,
                              const void* cons, void* best, int MB, int F,
                              int R, int K, void* stream) {
  if (MB <= 0 || R <= 0) return 0;
  if (F <= 0 || F > kMaxF) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)F * kBT;
  cudaError_t err = cudaFuncSetAttribute(
      first_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((MB + kBT - 1) / kBT, (R + kRulesPerBlock - 1) / kRulesPerBlock);
  first_match_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)baskets, (const int32_t*)blen, (const int32_t*)ant,
      (const int32_t*)size, (const int32_t*)cons, (int32_t*)best, MB, F, R,
      K);
  return (int)cudaGetLastError();
}
