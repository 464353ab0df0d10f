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
// len [MB] int32, ant [R, K] int32, size/cons [R] int32.  The first pass
// writes NO_MATCH into best; blocks lower it with atomicMin, so the result
// is exact in any block order.
//
// The caller's contract (a ValueError in ops/match_kernel.py for CPU
// tensors), which ops/contain.py `rule_table` and ops/bitmap.py
// `build_bitmap` meet: baskets are 0/1, every column index lies in
// [0, F), size[r] >= 1, and the positions k >= size[r] of ant[r] point at
// a column that is zero in every basket.  Then the sum equals size[r] iff
// the first min(size[r], K) positions all name items of the basket and
// size[r] <= K, which is what the kernel tests, stopping at the first
// missing item.
//
// What bounds it on the H100, and what the design does about it:
// - The work is a gather: per (basket, rule) check, a size compare and
//   one or a few bit lookups, and it ends at each basket's first match
//   (exact, because rank grows along the table).  At the T10I4D100K
//   shape's launch the baskets need 2.4e8 checks, most of them sweeping
//   the whole 123,377-rule table, so it is bound by issue and shared-
//   memory lookups, not by bytes.
// - Baskets as bits.  A first pass packs each basket's F bytes into F/32
//   words (16-byte loads, a byte compare and a multiply per 4 bytes), so
//   a group of 64 baskets takes 3 KB of shared memory at F = 384.  A
//   warp's 32 lanes read words of the same basket: at F <= 1,024 they lie
//   in distinct banks, so the lookups of one step are free of conflicts.
//   Above 256 words (F > 8,192) the baskets would not fit beside the rule
//   ring with several blocks per SM; a second form of the same kernel
//   reads the packed words from device memory (L1/L2), so F has no limit.
// - One rule per lane, a warp's baskets together.  A warp takes 32
//   consecutive rules of a staged tile into registers (size, consequent,
//   the first two antecedent columns) and checks them against each of its
//   live baskets (at most 8): first, free of branches for all of them at
//   once so that their loads are in flight together, the size against the
//   basket's length, the consequent bit and the first two antecedent
//   bits; then, per basket where a lane is still alive, later positions
//   while any lane needs them, and a ballot and __ffs for the basket's
//   exact first match in the step, where the basket stops.  Baskets no
//   longer wait for each other, and a warp's rule loads serve all its
//   baskets.
// - The rule table is staged, not chased.  Tiles of 256 rules stream into
//   a three-stage shared-memory ring by cp.async: each thread copies one
//   rule's size, consequent and first min(K, 32) antecedent columns, the
//   antecedents at an odd row stride, so lanes reading position k of 32
//   rules hit 32 banks.  Positions beyond 32 (never in the repo's tables)
//   are read from device memory when a lane reaches them.  No dependent
//   device-memory load is left in the inner loop.
// - Live baskets are compacted after every tile, so the block's 8 warps
//   share the baskets that are still unmatched.
// - A persistent wave of blocks takes (basket group, rule range) items
//   from a counter, ranges in rank order; the ranges are cut on the host
//   (ops/match_kernel.py `work_plan`) so that there are about 16 items
//   per block, which splits the rule table across the card when there
//   are few baskets (the vertical path's 232).  A basket whose running
//   minimum in `best` already lies below an item's range takes no work in
//   it, and a tile is not staged for an item whose baskets are all done.
// - The consequent is selected outside the kernel (ops/contain.py), as the
//   reference's `_strided_merge` does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kG = 64;                 // baskets per group
constexpr int kRT = kThreads;          // rules per tile: one per thread
constexpr int kSteps = kRT / 32;
constexpr int kPerWarp = kG / kWarps;  // live baskets a warp checks
constexpr int kStages = 3;
constexpr int kMaxStagedK = 32;        // antecedent positions staged
constexpr int kMaxSmemW = 256;         // packed words per basket in smem
constexpr int32_t kNoMatch = 0x7fffffff;

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Bit i of the result is set iff byte i of u is non-zero (i < 4).
__device__ __forceinline__ uint32_t nibble(uint32_t u) {
  return ((__vcmpne4(u, 0u) & 0x08040201u) * 0x01010101u) >> 24;
}

__device__ __forceinline__ uint32_t pack16(uint4 v) {
  return nibble(v.x) | nibble(v.y) << 4 | nibble(v.z) << 8 |
         nibble(v.w) << 12;
}

// packed[b, w] bit j = baskets[b, 32 w + j] != 0 for every row of the
// scratch (rows past MB are zero); best[b] = NO_MATCH; the work counter
// is zeroed.
__global__ void pack_kernel(const int8_t* __restrict__ baskets,
                            uint32_t* __restrict__ packed,
                            int32_t* __restrict__ best,
                            unsigned long long* __restrict__ counter, int MB,
                            int F, int W, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) *counter = 0;
  if (i >= total) return;
  const int b = (int)(i / W);
  const int w = (int)(i - (long long)b * W);
  uint32_t bits = 0;
  if (b < MB) {
    if (w == 0) best[b] = kNoMatch;
    const int8_t* row = baskets + (size_t)b * F;
    const int c0 = 32 * w;
    // Rows start on 16-byte boundaries when F is a multiple of 16.
    if ((F & 15) == 0 && c0 + 32 <= F) {
      const uint4* p = reinterpret_cast<const uint4*>(row + c0);
      bits = pack16(__ldg(p)) | pack16(__ldg(p + 1)) << 16;
    } else if ((F & 15) == 0 && c0 + 16 <= F) {
      bits = pack16(__ldg(reinterpret_cast<const uint4*>(row + c0)));
    } else {
      for (int j = 0; j < 32 && c0 + j < F; ++j)
        bits |= (uint32_t)(row[c0 + j] != 0) << j;
    }
  }
  packed[i] = bits;
}

template <bool kSmemBaskets>
__device__ __forceinline__ uint32_t word(const uint32_t* bw, int c) {
  return kSmemBaskets ? bw[c >> 5] : __ldg(bw + (c >> 5));
}

__device__ __forceinline__ bool bit(uint32_t w, int c) {
  return (w >> (c & 31)) & 1u;
}

// One staged tile of rules [r0, r0 + kRT) against the warp's live
// baskets (entries warp, warp + 8, ... of the live list): each lane holds
// one rule of a 32-rule step in registers and checks it against every
// basket still unmatched in this tile; a ballot and __ffs give a basket's
// first match in the step, and the basket stops there.
template <bool kSmemBaskets>
__device__ __forceinline__ void scan_tile(
    const int32_t* st, const uint32_t* s_bk, const uint32_t* packed,
    const int32_t* s_live, const int32_t* s_len, int32_t* s_found,
    int32_t* best, int b0, int nl, int W, int r0,
    const int32_t* __restrict__ ant, int K, int kst, int ks) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int slot[kPerWarp], len[kPerWarp];
  unsigned todo = 0;
#pragma unroll
  for (int u = 0; u < kPerWarp; ++u) {
    const int j = warp + kWarps * u;
    slot[u] = j < nl ? s_live[j] : 0;
    len[u] = s_len[slot[u]];
    if (j < nl) todo |= 1u << u;
  }
  const int32_t* s_size = st;
  const int32_t* s_cons = st + kRT;
  const int32_t* s_ant = st + 2 * kRT;
  for (int j = 0; j < kSteps && todo; ++j) {
    const int q = 32 * j + lane;
    const int sz = s_size[q];
    const int c = s_cons[q];
    const int32_t* a = s_ant + q * ks;
    const int a0 = a[0];
    const int a1 = kst > 1 ? a[1] : a0;
    // Phase 1, free of branches: the size and the first three lookups of
    // every live basket, so their loads are in flight together.
    unsigned alive_bits = 0;
#pragma unroll
    for (int u = 0; u < kPerWarp; ++u) {
      const uint32_t* bw = kSmemBaskets ? s_bk + slot[u] * W
                                        : packed + (size_t)(b0 + slot[u]) * W;
      const uint32_t xc = word<kSmemBaskets>(bw, c);
      const uint32_t x0 = word<kSmemBaskets>(bw, a0);
      const uint32_t x1 = word<kSmemBaskets>(bw, a1);
      const bool alive = (todo >> u & 1u) & (sz <= len[u]) & (sz <= K) &
                         !bit(xc, c) & bit(x0, a0) & ((sz < 2) | bit(x1, a1));
      alive_bits |= (unsigned)alive << u;
    }
    if (!__any_sync(kFull, alive_bits)) continue;
    // Phase 2: later positions, and each basket's first match.
#pragma unroll
    for (int u = 0; u < kPerWarp; ++u) {
      bool alive = alive_bits >> u & 1u;
      if (!__any_sync(kFull, alive)) continue;
      const uint32_t* bw = kSmemBaskets ? s_bk + slot[u] * W
                                        : packed + (size_t)(b0 + slot[u]) * W;
      for (int k = 2;; ++k) {
        const bool need = alive && k < sz;
        if (!__any_sync(kFull, need)) break;
        if (need) {
          const int col =
              k < kst ? a[k] : __ldg(ant + (size_t)(r0 + q) * K + k);
          alive = bit(word<kSmemBaskets>(bw, col), col);
        }
      }
      const unsigned hit = __ballot_sync(kFull, alive);
      if (hit) {
        todo &= ~(1u << u);
        if (lane == 0) {
          const int rank = r0 + 32 * j + __ffs(hit) - 1;
          s_found[slot[u]] = rank;
          atomicMin(best + b0 + slot[u], rank);
        }
      }
    }
  }
}

template <bool kSmemBaskets>
__global__ void __launch_bounds__(kThreads)
first_match_kernel(const uint32_t* __restrict__ packed,
                   const int32_t* __restrict__ blen,
                   const int32_t* __restrict__ ant,
                   const int32_t* __restrict__ size,
                   const int32_t* __restrict__ cons, int32_t* best,
                   unsigned long long* __restrict__ counter, int MB, int W,
                   int R, int K, int kst, int ks, int n_groups,
                   int tiles_per_range, int n_tiles, long long items) {
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ int32_t s_live[kG];   // slots still unmatched, compacted
  __shared__ int32_t s_len[kG];
  __shared__ int32_t s_limit[kG];  // best[b] at item start
  __shared__ int32_t s_found[kG];
  __shared__ int s_nlive;
  __shared__ unsigned long long s_next;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int stage_words = kRT * (2 + ks);
  uint32_t* s_bk = reinterpret_cast<uint32_t*>(smem + kStages * stage_words);

  if (tid == 0) s_next = atomicAdd(counter, 1ull);
  __syncthreads();
  unsigned long long item = s_next;
  __syncthreads();

  // Stage rule tile `tile` into ring slot `stage`: thread t copies rule
  // tile * kRT + t; rules past R get a size no basket reaches and column
  // 0 everywhere (the scan looks columns up before it tests the size).
  auto issue = [&](int tile, int stage) {
    int32_t* st = smem + stage * stage_words;
    const int r = tile * kRT + tid;
    int32_t* d = st + 2 * kRT + tid * ks;
    if (r < R) {
      cp_async4(st + tid, size + r);
      cp_async4(st + kRT + tid, cons + r);
      const int32_t* a = ant + (size_t)r * K;
      for (int k = 0; k < kst; ++k) cp_async4(d + k, a + k);
    } else {
      st[tid] = kNoMatch;
      st[kRT + tid] = 0;
      for (int k = 0; k < kst; ++k) d[k] = 0;
    }
  };

  while (item < (unsigned long long)items) {
    const int group = (int)(item % n_groups);
    const int range = (int)(item / n_groups);
    const int t0 = range * tiles_per_range;
    const int n = min(n_tiles, t0 + tiles_per_range) - t0;
    const int b0 = group * kG;

    // The group's live baskets: real rows (len > 0) whose running minimum
    // does not already lie below this range.
    if (warp == 0) {
      int n_live = 0;
      for (int h = 0; h < kG; h += 32) {
        const int slot = h + lane;
        const int b = b0 + slot;
        int len = 0, lim = kNoMatch;
        if (b < MB) {
          len = blen[b];
          lim = *(volatile const int32_t*)(best + b);
        }
        s_len[slot] = len;
        s_limit[slot] = lim;
        s_found[slot] = kNoMatch;
        const bool live = len > 0 && lim > t0 * kRT;
        const unsigned bal = __ballot_sync(kFull, live);
        if (live) s_live[n_live + __popc(bal & ((1u << lane) - 1u))] = slot;
        n_live += __popc(bal);
      }
      if (lane == 0) {
        s_nlive = n_live;
        s_next = atomicAdd(counter, 1ull);
      }
    }
    __syncthreads();
    const unsigned long long next = s_next;
    if (s_nlive > 0) {
      if (kSmemBaskets) {
        const uint32_t* src = packed + (size_t)b0 * W;
        for (int i = tid; i < kG * W / 4; i += kThreads)
          cp_async16(s_bk + 4 * i, src + 4 * i);
      }
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < n) issue(t0 + s, s);
        cp_async_commit();
      }
      for (int i = 0; i < n; ++i) {
        if (i + kStages - 1 < n)
          issue(t0 + i + kStages - 1, (i + kStages - 1) % kStages);
        cp_async_commit();
        cp_async_wait<kStages - 1>();
        __syncthreads();
        const int nl = s_nlive;
        if (nl == 0) break;
        const int32_t* st = smem + (i % kStages) * stage_words;
        const int r0 = (t0 + i) * kRT;
        scan_tile<kSmemBaskets>(st, s_bk, packed, s_live, s_len, s_found,
                                best, b0, nl, W, r0, ant, K, kst, ks);
        __syncthreads();
        if (warp == 0) {
          // Keep the slots that neither matched nor hold a running
          // minimum below the next tile.
          const int next_r0 = r0 + kRT;
          int keep_slot[kG / 32];
          bool keep[kG / 32];
          for (int h = 0; h < kG / 32; ++h) {
            const int idx = 32 * h + lane;
            keep_slot[h] = idx < nl ? s_live[idx] : 0;
            keep[h] = idx < nl && s_found[keep_slot[h]] == kNoMatch &&
                      s_limit[keep_slot[h]] > next_r0;
          }
          __syncwarp();
          int n_live = 0;
          for (int h = 0; h < kG / 32; ++h) {
            const unsigned bal = __ballot_sync(kFull, keep[h]);
            if (keep[h])
              s_live[n_live + __popc(bal & ((1u << lane) - 1u))] =
                  keep_slot[h];
            n_live += __popc(bal);
          }
          if (lane == 0) s_nlive = n_live;
        }
      }
      cp_async_wait<0>();
    }
    __syncthreads();  // shared state is rewritten by the next item
    item = next;
  }
}

struct Form {
  int kst, ks, smem;
  bool smem_baskets;
};

Form form_for(int F, int K) {
  Form f;
  const int W = (F + 31) / 32;
  f.kst = K < kMaxStagedK ? K : kMaxStagedK;
  f.ks = f.kst | 1;  // odd stride: position k of 32 rules in 32 banks
  f.smem_baskets = W <= kMaxSmemW;
  f.smem = kStages * kRT * (2 + f.ks) * 4 + (f.smem_baskets ? kG * W * 4 : 0);
  return f;
}

template <bool kSmemBaskets>
cudaError_t set_smem(const Form& f) {
  return cudaFuncSetAttribute(first_match_kernel<kSmemBaskets>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              f.smem);
}

template <bool kSmemBaskets>
cudaError_t blocks_per_sm(const Form& f, int* per_sm) {
  const cudaError_t err = set_smem<kSmemBaskets>(f);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, first_match_kernel<kSmemBaskets>, kThreads, f.smem);
}

}  // namespace

// Blocks of one full wave of the match kernel at this F and K (SMs x
// resident blocks per SM), or minus a CUDA error code.
extern "C" int fa_first_match_blocks(int F, int K) {
  if (F <= 0 || K <= 0) return -(int)cudaErrorInvalidValue;
  const Form f = form_for(F, K);
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = f.smem_baskets ? blocks_per_sm<true>(f, &per_sm)
                                   : blocks_per_sm<false>(f, &per_sm);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm <= 0) return -(int)cudaErrorInvalidConfiguration;
  return sms * per_sm;
}

// scratch: n_groups * 64 * ceil(F / 32) packed words, then the 8-byte work
// counter; best [MB] is written whole.  The work is n_groups basket groups
// x ceil(ceil(R / 256) / tiles_per_range) rule ranges of tiles_per_range
// 256-rule tiles, run by `blocks` persistent blocks.  Launches on `stream`
// and returns cudaGetLastError() (0 = launched).
extern "C" int fa_first_match(const void* baskets, const void* blen,
                              const void* ant, const void* size,
                              const void* cons, void* scratch, void* best,
                              int MB, int F, int R, int K, int n_groups,
                              int tiles_per_range, int blocks, void* stream) {
  if (MB <= 0 || R <= 0) return 0;
  if (F <= 0 || K <= 0 || tiles_per_range <= 0 || blocks <= 0 ||
      n_groups != (MB + kG - 1) / kG)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int W = (F + 31) / 32;
  const long long words = (long long)n_groups * kG * W;
  uint32_t* packed = (uint32_t*)scratch;
  unsigned long long* counter = (unsigned long long*)(packed + words);
  pack_kernel<<<(unsigned)((words + kThreads - 1) / kThreads), kThreads, 0,
                st>>>((const int8_t*)baskets, packed, (int32_t*)best,
                      counter, MB, F, W, words);
  const int n_tiles = (R + kRT - 1) / kRT;
  const long long items =
      (long long)n_groups * ((n_tiles + tiles_per_range - 1) / tiles_per_range);
  const unsigned grid = (unsigned)(blocks < items ? blocks : items);
  const Form f = form_for(F, K);
  const cudaError_t err =
      f.smem_baskets ? set_smem<true>(f) : set_smem<false>(f);
  if (err != cudaSuccess) return (int)err;
  if (f.smem_baskets)
    first_match_kernel<true><<<grid, kThreads, f.smem, st>>>(
        packed, (const int32_t*)blen, (const int32_t*)ant,
        (const int32_t*)size, (const int32_t*)cons, (int32_t*)best, counter,
        MB, W, R, K, f.kst, f.ks, n_groups, tiles_per_range, n_tiles, items);
  else
    first_match_kernel<false><<<grid, kThreads, f.smem, st>>>(
        packed, (const int32_t*)blen, (const int32_t*)ant,
        (const int32_t*)size, (const int32_t*)cons, (int32_t*)best, counter,
        MB, W, R, K, f.kst, f.ks, n_groups, tiles_per_range, n_tiles, items);
  return (int)cudaGetLastError();
}
