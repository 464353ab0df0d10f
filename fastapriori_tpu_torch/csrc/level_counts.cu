// K1 on Hopper: fused prefix containment + weighted extension counting.
//
// Replaces the Pallas TPU kernel fastapriori_tpu/ops/pallas_level.py
// `_kernel` (launched through `level_counts_pallas`):
//
//   counts[m, f] = sum_t WB[t, f] * [ sum_j S[m, j] * B[t, j] == k1 ]
//
// with B [T, F] the 0/1 int8 transaction bitmap, WB = (w mod 128) (.) B
// [T, F] int8, S [M, F] the 0/1 int8 one-hot prefix rows and k1 = k - 1
// a runtime scalar.  Output [M, F] int32, zeroed by the caller; blocks add
// their partial sums with integer atomics, so the result is exact and
// independent of the order the work runs in.
//
// The caller's contract (a device-side assert here, a ValueError in
// ops/level_kernel.py for CPU tensors): B and S are 0/1 and no row of S
// holds more than k1 items, as ops/count.py `prefix_onehot` builds them
// (a prefix of k1 distinct items, or a padding row with one item in the
// all-zero column).  The overlap of a row of exactly k1 items equals k1
// iff the row is a subset of the transaction; a row with fewer items
// never matches.
//
// What bounds it on the H100, and what the design does about it:
// - Two products.  Membership: each (prefix, transaction) pair is tested,
//   M x T pairs.  Counting: each contained pair adds its WB row; it is
//   sparse (3.16 M of the 359 M real pairs at the T10I4D100K shape's
//   k = 3), so only contained pairs are visited, from warp-uniform bit
//   masks, into register accumulators (a warp owns four prefix rows, a
//   lane 12 columns of each: 48 registers, no spills at 2 blocks per SM).
// - Membership, packed and word-sparse.  B is bit-packed once per launch into 32-bit words, stored word-major
//   ([F/32][T], so a warp reads 32 transactions' word with one 128-byte
//   access).  Each prefix row is reduced once per launch to its list of
//   non-zero words (at most k1 of them), so a pair costs one AND-NOT per
//   listed word instead of F/32 (k1 = 2 at F = 384: 2 tests, not 12), and
//   a warp tests 32 transactions at once, a ballot giving the contained
//   mask.
// - Counting from packed rows.  A WB row holds ~10 non-zero bytes of 384,
//   and WB = w (.) B gives each row one value: the same first pass packs
//   WB's non-zero bits and that value, so a contained pair reads 3 words
//   and a value, not 384 bytes scattered over 27 MB (reading the bytes,
//   the counting waited on L2 and took most of the time).  A row whose
//   non-zero values differ is flagged and read as bytes: exact for any WB.
// - Memory waits off the critical path.  Within a work item, sub-tiles of
//   32 G transactions (512 at F = 384) stream through two shared-memory
//   stages filled by cp.async: B's packed words for the membership, the
//   item's F slice of WB's packed bits and the row values for the
//   counting, so sub-tile i + 1 arrives while sub-tile i is tested and
//   counted from shared memory alone, with one barrier per sub-tile.  A
//   tile's row lists are read into shared memory once per item.
// - Schedule: one wave of persistent blocks.  The first pass also lists
//   the 32-row prefix tiles that hold a row of exactly k1 items; tiles of
//   only padding rows take no work.  Work items are (tile, 384-column F
//   slice, T range), the T ranges cut on the device so that there are
//   about 16 items per block, taken from a counter, so no partial second
//   wave is left.
// - Why not the tensor cores: the Pallas kernel's own membership, int8
//   mma.sync.m16n8k32 of S and B tiles (F padded to 32, the overlap
//   compared with k1 in registers, the result bits passed to the counting
//   warps through shared memory), was built and timed in turns with this
//   packed form at the T10I4D100K shape's k = 3 launch on an H100: about
//   5.5 ms against 1.07 ms.  It reads B as int8 (8x the packed bytes) once
//   per 32-row tile, does F multiply-adds per pair where the packed form
//   does k1 tests, and needs a second barrier per sub-tile; it was
//   dropped.
// - Any F.  A row's word list is bounded by k1, not by F; what grows with
//   F is the packed B sub-tile the staged form copies into shared memory
//   (all F / 32 words of 32 G transactions).  Up to kMaxStagedWords words
//   (F <= 12,288) B is staged; above, the membership reads each listed
//   word of B from device memory (one 128-byte access per warp and group,
//   only for the words a row lists), the stages hold only the counting
//   side, and G = 16.  The packing grid loops over words past the grid's
//   y limit, and every index into the scratch is 64-bit.
// Ragged T, M and F are masked in the kernel, and k1 is an int32, so
// there is no k1 <= 127 limit and no tile-divisibility requirement.

#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kMT = kWarps * kRowsPerWarp;  // 32 prefix rows per tile
constexpr int kWordsPerLane = 3;            // int8x4 words of WB per lane
constexpr int kFS = 128 * kWordsPerLane;    // 384 columns per F slice
constexpr int kMaxStagedWords = 384;        // B staged in shared memory up
                                            // to F = 12,288
constexpr int kMaxGridY = 65535;
constexpr int kTPad = 512;                  // packed B row padding
constexpr int kItemsPerBlock = 16;
constexpr int kSlots = 4 * kWordsPerLane;   // accumulator slots per lane
constexpr int kSliceWords = kFS / 32;       // packed words per F slice
constexpr int32_t kMixed = INT32_MIN;       // wv of a row of mixed values
constexpr int kListCap = 8;                 // listed words per row kept in
                                            // shared memory for an item

struct Scratch {
  uint32_t* bp;         // [words][Tp] packed B, word-major
  uint32_t* wm;         // [Tp][wstride] non-zero bits of WB, transaction-
                        // major, rows padded to a multiple of 4 words
  int32_t* wv;          // [Tp] a WB row's one non-zero value (0: none),
                        // or kMixed when its non-zero values differ
  uint2* slist;         // [M][L] (word, bits) of each row's non-zero words
  int32_t* nw;          // [M] listed words, or -1: the row never matches
  int32_t* tile_flag;   // [n_tiles], zeroed
  int32_t* tile_list;   // [n_tiles]
  int32_t* n_live;      // zeroed
  unsigned long long* counter;  // zeroed
  int words;            // packed words per row
  int wstride;          // words rounded up to a multiple of 4
};

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

// Bytes c .. c + 3 of a row as a word (zero past F).
__device__ __forceinline__ uint32_t load4(const int8_t* row, int c, int F,
                                          bool aligned4) {
  if (aligned4) return c < F ? *reinterpret_cast<const uint32_t*>(row + c) : 0u;
  uint32_t word = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (c + b < F) word |= (uint32_t)(uint8_t)row[c + b] << (8 * b);
  return word;
}

// One thread per (transaction t, word w), grid (T blocks, words, looping
// past the grid's y limit): B ->
// word-major packed bits (word w holds columns 32 w .. 32 w + 31, bit j =
// column 32 w + j); WB -> its non-zero bits in the same layout,
// transaction-major, and its value when every non-zero entry of the row
// has the same one (WB = w (.) B gives that: then a contained pair adds w
// to each set column), merged across a row's words with atomics on the
// zeroed values.  Transactions >= T are 0.
__global__ void pack_kernel(const int8_t* __restrict__ B,
                            const int8_t* __restrict__ WB, Scratch sc, int T,
                            int F, int words, int Tp, int aligned4,
                            int aligned16) {
  for (int w = blockIdx.y; w < sc.wstride; w += gridDim.y) {
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < Tp;
       t += gridDim.x * blockDim.x) {
    uint32_t b_bits = 0, w_bits = 0;
    int32_t v0 = 0;
    bool mixed = false;
    if (t < T) {
      const int8_t* brow = B + (size_t)t * F;
      const int8_t* wrow = WB + (size_t)t * F;
      uint32_t bw[8], ww[8];
      if (aligned16 && 32 * w + 32 <= F) {
        const uint4* bq = reinterpret_cast<const uint4*>(brow + 32 * w);
        const uint4* wq = reinterpret_cast<const uint4*>(wrow + 32 * w);
        const uint4 b0 = bq[0], b1 = bq[1], w0 = wq[0], w1 = wq[1];
        bw[0] = b0.x; bw[1] = b0.y; bw[2] = b0.z; bw[3] = b0.w;
        bw[4] = b1.x; bw[5] = b1.y; bw[6] = b1.z; bw[7] = b1.w;
        ww[0] = w0.x; ww[1] = w0.y; ww[2] = w0.z; ww[3] = w0.w;
        ww[4] = w1.x; ww[5] = w1.y; ww[6] = w1.z; ww[7] = w1.w;
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          bw[q] = load4(brow, 32 * w + 4 * q, F, aligned4);
          ww[q] = load4(wrow, 32 * w + 4 * q, F, aligned4);
        }
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint32_t bv = __vcmpne4(bw[q], 0u);
        b_bits |= (((bv & 0x01010101u) * 0x01020408u) >> 24 & 0xfu) << (4 * q);
        const uint32_t wv = ww[q];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int32_t v = (int8_t)(wv >> (8 * b));
          if (v == 0) continue;
          w_bits |= 1u << (4 * q + b);
          if (v0 == 0) v0 = v;
          mixed |= v != v0;
        }
      }
    }
    if (w < words) sc.bp[(size_t)w * Tp + t] = b_bits;
    sc.wm[(size_t)t * sc.wstride + w] = w_bits;
    if (mixed) {
      atomicExch(sc.wv + t, kMixed);
    } else if (v0 != 0) {
      const int32_t old = atomicCAS(sc.wv + t, 0, v0);
      if (old != 0 && old != v0) atomicExch(sc.wv + t, kMixed);
    }
  }
  }
}

// Each prefix row -> its non-zero packed words, its item count checked
// against k1; rows of exactly k1 items are live, and their tiles are
// listed once each.
__global__ void prep_rows_kernel(const int8_t* __restrict__ S, Scratch sc,
                                 int M, int F, int words, int L, int k1) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  for (int m = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); m < M;
       m += warps) {
    const int8_t* row = S + (size_t)m * F;
    int pop = 0, n = 0;
    for (int w = 0; w < words; ++w) {
      const int c = 32 * w + lane;
      const uint32_t word = __ballot_sync(kFull, c < F && row[c] != 0);
      pop += __popc(word);
      if (word != 0) {
        if (lane == 0 && n < L) sc.slist[(size_t)m * L + n] = make_uint2(w, word);
        ++n;
      }
    }
    // The caller's contract; a wider row would need an overlap count.
    assert(pop <= k1);
    const bool live = pop == k1;
    if (lane == 0) {
      sc.nw[m] = live ? n : -1;
      if (live && atomicCAS(sc.tile_flag + m / kMT, 0, 1) == 0)
        sc.tile_list[atomicAdd(sc.n_live, 1)] = m / kMT;
    }
  }
}

struct Item {
  int tile, f0, t_begin, t_end;
};

// The block's next item, or false when none is left.  Items run
// (tile, F slice, T range); the T ranges are cut so that there are about
// kItemsPerBlock items per block.
__device__ bool next_item(const Scratch& sc, int T, int F, int tt,
                          Item* it) {
  __shared__ unsigned long long taken;
  __syncthreads();  // the previous item's shared data are consumed
  if (threadIdx.x == 0) taken = atomicAdd(sc.counter, 1ull);
  __syncthreads();
  const long long n_live = *sc.n_live;
  const int f_tiles = (F + kFS - 1) / kFS;
  const long long n_sub = (T + tt - 1) / tt;
  const long long tiles = n_live * f_tiles;
  if (tiles == 0) return false;
  long long splits = ((long long)kItemsPerBlock * gridDim.x + tiles - 1) / tiles;
  splits = splits < 1 ? 1 : (splits > n_sub ? n_sub : splits);
  const long long sub_per = (n_sub + splits - 1) / splits;
  splits = (n_sub + sub_per - 1) / sub_per;
  if ((long long)taken >= tiles * splits) return false;
  const long long q = (long long)taken / splits;
  const long long split = (long long)taken - q * splits;
  it->tile = sc.tile_list[q / f_tiles];
  it->f0 = (int)(q % f_tiles) * kFS;
  it->t_begin = (int)(split * sub_per * tt);
  const long long e = (split + 1) * sub_per * tt;
  it->t_end = (int)(e < T ? e : T);
  return true;
}

// Bits of the transactions t .. t + 31 that lie below t_end.
__device__ __forceinline__ uint32_t valid_bits(int t, int t_end) {
  const int n = t_end - t;
  return n >= 32 ? kFull : (n <= 0 ? 0u : (1u << n) - 1u);
}

// What the counting side reads: WB itself, and its packed form in a
// shared-memory stage: `wm` points at the F slice's first packed word of
// transaction `base` (the sub-tile's first), rows `stride` words apart;
// `wv` at the value of `base`.
struct Rows {
  const int8_t* WB;
  const uint32_t* wm;
  const int32_t* wv;
  int base, stride, F, words, f0;
  bool aligned4;  // WB rows can be read as words
};

// The counting side: acc (one prefix row's 12
// columns of this lane: f0 + 128 i + 4 lane + b in slot 4 i + b) += the
// WB slice of each transaction t_base + bit of the warp-uniform `mask`.
// A row of one value (all rows, for WB = w (.) B) is read as that value
// and the 4 bits of each of the lane's 3 column quads, added without a
// branch; a row of mixed values as its 12 bytes, from device memory.
__device__ __forceinline__ void count_mask(int (&acc)[kSlots], uint32_t mask,
                                           int t_base, const Rows& w,
                                           int lane) {
  while (mask) {
    const int t = t_base + __ffs(mask) - 1;
    mask &= mask - 1;
    const int v = w.wv[t - w.base];
    if (v != kMixed) {
#pragma unroll
      for (int i = 0; i < kWordsPerLane; ++i) {
        const int wi = 4 * i + lane / 8;  // packed word within the F slice
        const uint32_t x =
            w.f0 / 32 + wi < w.words
                ? w.wm[(size_t)(t - w.base) * w.stride + wi] >> (4 * (lane & 7))
                : 0u;
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[4 * i + b] += (int)((x >> b) & 1u) * v;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kWordsPerLane; ++i) {
        const uint32_t x = load4(w.WB + (size_t)t * w.F,
                                 w.f0 + 128 * i + 4 * lane, w.F, w.aligned4);
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[4 * i + b] += (int)(int8_t)(x >> (8 * b));
      }
    }
  }
}

// Walks the contained masks of a sub-tile's groups, lane g holding group
// g's in `mine`: one loop over the non-empty groups, not one copy each.
__device__ __forceinline__ void count_groups(int (&acc)[kSlots], uint32_t mine,
                                             int t0, const Rows& w, int lane) {
  for (unsigned groups = __ballot_sync(kFull, mine != 0); groups;
       groups &= groups - 1) {
    const int g = __ffs(groups) - 1;
    count_mask(acc, __shfl_sync(kFull, mine, g), t0 + 32 * g, w, lane);
  }
}

// Adds a warp's accumulators of one item to `out` (integer atomics) and
// zeroes them.
__device__ __forceinline__ void flush(int (&acc)[kRowsPerWarp][kSlots],
                                      int32_t* __restrict__ out, int m0,
                                      int M, int F, int f0, int lane) {
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int m = m0 + rr;
#pragma unroll
    for (int slot = 0; slot < kSlots; ++slot) {
      const int c = f0 + 128 * (slot / 4) + 4 * lane + slot % 4;
      const int v = acc[rr][slot];
      if (m < M && c < F && v != 0) atomicAdd(out + (size_t)m * F + c, v);
      acc[rr][slot] = 0;
    }
  }
}

// The packed, word-sparse form.  Shared memory: two stages of a sub-tile
// of 32 G transactions, each [words][32 G] packed B words (word-major, for
// the membership; only with kStageB), [32 G][12] packed WB bits of the
// item's F slice and [32 G] WB row values (for the counting).  Sub-tile
// i + 1 streams in by cp.async while sub-tile i is tested and counted from
// shared memory, so with kStageB no warp waits on device memory between
// barriers; without it (F > 12,288) the membership reads the listed words
// of B from device memory.  Each warp owns four prefix rows and their
// register accumulators.
template <int G, bool kStageB>
__global__ void __launch_bounds__(kThreads, 2)
level_counts_packed(const int8_t* __restrict__ WB, int32_t* __restrict__ out,
                    Scratch sc, int T, int F, int M, int Tp, int L,
                    int wb_aligned) {
  constexpr int kTT = 32 * G;
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int words = sc.words;
  // B words (staged form only), the F slice's WB bits, WB values
  const int b_words = kStageB ? words * kTT : 0;
  const int stage_words = b_words + kSliceWords * kTT + kTT;
  // The tile's rows: listed words (the first kListCap of each) and counts,
  // read once per item.
  __shared__ uint2 lists_s[kMT][kListCap];
  __shared__ int nw_s[kMT];
  int acc[kRowsPerWarp][kSlots];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
    for (int slot = 0; slot < kSlots; ++slot) acc[rr][slot] = 0;
  Item it;
  while (next_item(sc, T, F, kTT, &it)) {
    const int m0 = it.tile * kMT + warp * kRowsPerWarp;
    for (int i = threadIdx.x; i < kMT * kListCap; i += kThreads) {
      const int r = i / kListCap, j = i % kListCap;
      const int m = it.tile * kMT + r;
      if (j == 0) nw_s[r] = m < M ? sc.nw[m] : -1;
      if (m < M && j < L) lists_s[r][j] = sc.slist[(size_t)m * L + j];
    }
    const int n_sub = (it.t_end - it.t_begin + kTT - 1) / kTT;
    auto stage_in = [&](int s) {
      if (s >= n_sub) return;
      uint32_t* dst = smem + (s & 1) * stage_words;
      const int t0 = it.t_begin + s * kTT;
      if (kStageB) {
        for (int i = threadIdx.x; i < words * kTT / 4; i += kThreads) {
          const int wi = i / (kTT / 4);
          const int q = i - wi * (kTT / 4);
          cp_async16(dst + wi * kTT + 4 * q,
                     sc.bp + (size_t)wi * Tp + t0 + 4 * q);
        }
      }
      for (int i = threadIdx.x; i < kTT * kSliceWords / 4; i += kThreads) {
        const int r = i / (kSliceWords / 4);
        const int q = i - r * (kSliceWords / 4);
        cp_async16(dst + b_words + kSliceWords * r + 4 * q,
                   sc.wm + (size_t)(t0 + r) * sc.wstride + it.f0 / 32 + 4 * q);
      }
      for (int i = threadIdx.x; i < kTT / 4; i += kThreads)
        cp_async16(dst + b_words + kSliceWords * kTT + 4 * i, sc.wv + t0 + 4 * i);
      cp_async_commit();
    };
    stage_in(0);
    for (int s = 0; s < n_sub; ++s) {
      cp_async_wait<0>();
      __syncthreads();  // stage s is in; stage s - 1 is consumed
      stage_in(s + 1);
      const uint32_t* stage = smem + (s & 1) * stage_words;
      const uint32_t* bs = stage + lane;
      const int t0 = it.t_begin + s * kTT;
      const bool full = t0 + kTT <= it.t_end;
      const Rows w{WB, stage + b_words,
                   reinterpret_cast<const int32_t*>(
                       stage + b_words + kSliceWords * kTT),
                   t0, kSliceWords, F, words, it.f0, wb_aligned != 0};
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int r = warp * kRowsPerWarp + rr;
        const int nw = nw_s[r];
        if (nw < 0) continue;
        uint32_t miss[G];
#pragma unroll
        for (int g = 0; g < G; ++g) miss[g] = 0;
        const uint2* lst = sc.slist + (size_t)(m0 + rr) * L;
        for (int j = 0; j < nw; ++j) {
          const uint2 e = j < kListCap ? lists_s[r][j] : __ldg(lst + j);
          if (kStageB) {
            const uint32_t* col = bs + e.x * kTT;
#pragma unroll
            for (int g = 0; g < G; ++g) miss[g] |= e.y & ~col[32 * g];
          } else {
            const uint32_t* col = sc.bp + (size_t)e.x * Tp + t0 + lane;
#pragma unroll
            for (int g = 0; g < G; ++g) miss[g] |= e.y & ~__ldg(col + 32 * g);
          }
        }
        uint32_t mine = 0;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          uint32_t mask = __ballot_sync(kFull, miss[g] == 0);
          if (!full) mask &= valid_bits(t0 + 32 * g, it.t_end);
          if (lane == g) mine = mask;
        }
        count_groups(acc[rr], mine, t0, w, lane);
      }
    }
    flush(acc, out, m0, M, F, it.f0, lane);
  }
}

template <typename Kernel>
int persistent_blocks(Kernel kernel, size_t smem, int* blocks) {
  int dev = 0, sms = 132, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  return 0;
}

// Transactions per sub-tile, 32 G: the largest G <= 16 whose two stages
// of `words` packed B words, an F slice of packed WB bits and a WB value
// per transaction fit in 110 KiB of shared memory (two blocks per SM).
int pick_g(int words) {
  const size_t row_bytes = (size_t)4 * (words + kSliceWords + 1);
  int g = 16;
  while (g > 1 && (size_t)2 * 32 * g * row_bytes > 110 * 1024) g >>= 1;
  return g;
}

template <int G, bool kStageB = true>
int launch_packed(const void* WB, void* out, const Scratch& sc, int T, int F,
                  int M, int Tp, int L, int aligned, cudaStream_t st) {
  const size_t smem = (size_t)2 * ((kStageB ? sc.words : 0) + kSliceWords + 1) *
                      32 * G * sizeof(uint32_t);
  int blocks = 0;
  const int err =
      persistent_blocks(level_counts_packed<G, kStageB>, smem, &blocks);
  if (err) return err;
  level_counts_packed<G, kStageB><<<blocks, kThreads, smem, st>>>(
      (const int8_t*)WB, (int32_t*)out, sc, T, F, M, Tp, L, aligned);
  return 0;
}

}  // namespace

// Bytes of scratch fa_level_counts needs (16-byte aligned by the caller).
extern "C" long long fa_level_counts_scratch(int T, int F, int M, int k1) {
  const long long words = (F + 31) / 32;
  const long long tp = ((long long)T + kTPad - 1) / kTPad * kTPad;
  const long long L = k1 < 1 ? 1 : (k1 < words ? k1 : words);
  const long long tiles = ((long long)M + kMT - 1) / kMT;
  const long long wstride = (words + 3) / 4 * 4;
  // packed B, packed WB (plus one F slice read past the last row), WB
  // values, row lists, word counts, tile list and the zeroed block
  const long long n = 4 * words * tp + 4 * (wstride * tp + kSliceWords) +
                      4 * tp + 8 * (long long)M * L + 4LL * M + 8 * tiles +
                      128;
  return (n + 15) / 16 * 16;
}

// B, WB: [T, F] int8; S: [M, F] int8; out: [M, F] int32, zero-filled;
// scratch: fa_level_counts_scratch bytes.  Launches the preparation
// passes and the counting kernel on `stream`; returns cudaGetLastError()
// (0 = launched).
extern "C" int fa_level_counts(const void* B, const void* WB, const void* S,
                               void* out, void* scratch, int T, int F, int M,
                               int k1, void* stream) {
  if (T <= 0 || F <= 0 || M <= 0) return 0;
  const int words = (F + 31) / 32;
  cudaStream_t st = (cudaStream_t)stream;
  const int Tp = (T + kTPad - 1) / kTPad * kTPad;
  const int L = k1 < 1 ? 1 : (k1 < words ? k1 : words);
  const int tiles = (M + kMT - 1) / kMT;
  // Layout: the zeroed block first (tile flags, n_live, counter), then
  // the rest.
  char* p = (char*)scratch;
  Scratch sc;
  sc.words = words;
  sc.wstride = (words + 3) / 4 * 4;
  sc.counter = (unsigned long long*)p;
  sc.n_live = (int32_t*)(p + 8);
  sc.tile_flag = (int32_t*)(p + 16);
  const size_t zeroed = 16 + (size_t)4 * tiles;
  p += (zeroed + 15) / 16 * 16;
  sc.bp = (uint32_t*)p;
  p += (size_t)4 * words * Tp;
  sc.wm = (uint32_t*)p;
  p += (size_t)4 * ((size_t)sc.wstride * Tp + kSliceWords);
  sc.wv = (int32_t*)p;
  p += (size_t)4 * Tp;
  sc.slist = (uint2*)p;
  p += (size_t)8 * M * L;
  sc.nw = (int32_t*)p;
  p += (size_t)4 * M;
  sc.tile_list = (int32_t*)p;
  cudaError_t err = cudaMemsetAsync(scratch, 0, zeroed, st);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int aligned = F % 4 == 0 && (uintptr_t)WB % 4 == 0 ? 1 : 0;
  err = cudaMemsetAsync(sc.wv, 0, (size_t)4 * Tp, st);
  if (err != cudaSuccess) return (int)err;
  const int pack_x = (Tp + kThreads - 1) / kThreads;
  pack_kernel<<<dim3(pack_x < 2 * sms ? pack_x : 2 * sms,
                     sc.wstride < kMaxGridY ? sc.wstride : kMaxGridY),
                kThreads, 0, st>>>(
      (const int8_t*)B, (const int8_t*)WB, sc, T, F, words, Tp,
      F % 4 == 0 && (uintptr_t)B % 4 == 0 && (uintptr_t)WB % 4 == 0,
      F % 16 == 0 && (uintptr_t)B % 16 == 0 && (uintptr_t)WB % 16 == 0);
  const int row_blocks = (M + kWarps - 1) / kWarps;
  prep_rows_kernel<<<row_blocks < 8 * sms ? row_blocks : 8 * sms, kThreads, 0,
                     st>>>((const int8_t*)S, sc, M, F, words, L, k1);
  int rc = 0;
  if (words > kMaxStagedWords) {
    rc = launch_packed<16, false>(WB, out, sc, T, F, M, Tp, L, aligned, st);
    if (rc) return rc;
    return (int)cudaGetLastError();
  }
  switch (pick_g(words)) {
    case 16: rc = launch_packed<16>(WB, out, sc, T, F, M, Tp, L, aligned, st); break;
    case 8: rc = launch_packed<8>(WB, out, sc, T, F, M, Tp, L, aligned, st); break;
    case 4: rc = launch_packed<4>(WB, out, sc, T, F, M, Tp, L, aligned, st); break;
    case 2: rc = launch_packed<2>(WB, out, sc, T, F, M, Tp, L, aligned, st); break;
    default: rc = launch_packed<1>(WB, out, sc, T, F, M, Tp, L, aligned, st); break;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
