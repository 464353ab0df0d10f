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
// independent of block order.
//
// What bounds it on the H100, and what the design does about it:
// - The dense formulation is two int8 products of 2*T*M*F operations each
//   with a [M, T] membership intermediate between them.  On the TPU that
//   intermediate stayed in VMEM; here it never leaves the block either: a
//   [64 prefixes x 64 transactions] membership tile lives in registers and
//   is reduced at once to one 64-bit containment mask per prefix.
// - Membership is 1 bit per (row, item).  A first pass packs B and S into
//   32-bit words (one ballot per 32 columns, B read once per launch); the
//   counting kernel then stages 64-row tiles of packed words in shared
//   memory.  The caller's contract (a device-side assert here, a
//   ValueError in ops/level_kernel.py for CPU tensors): B and S are 0/1
//   and no row of S holds more than k1 items, as
//   ops/count.py `prefix_onehot` builds them (a prefix of k1 distinct
//   items, or a padding row with one item in the all-zero column).  The
//   overlap of a row holding exactly k1 items equals k1 iff the row is a
//   subset of the transaction, so a (prefix, transaction) pair costs F/32
//   fused AND-NOT/OR instructions (LOP3) instead of F multiply-adds; rows
//   with fewer items never match, and a block whose rows all have fewer
//   (the pow2 padding of the prefix axis) returns at once.  Each thread
//   owns a 4 x 4 micro-tile, so 8 shared loads feed 16 word tests; which
//   of its 4 rows can match is decided once per block, and the word loop
//   is unrolled by 4.  This membership work, M*T*F/32 word tests, bounds
//   the kernel.
// - The counting product is sparse: most (prefix, transaction) pairs do
//   not contain the prefix.  Only WB rows that hold at least one of the
//   block's prefixes are read, and each contained pair adds its WB row
//   slice to register accumulators; non-contained pairs cost nothing.
// The grid is (prefix tiles, 384-column slices of F, transaction splits);
// ragged T, M and F are masked in the kernel, and k1 is an int32, so
// there is no k1 <= 127 limit and no tile-divisibility requirement.

#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMT = 64;                       // prefix rows per block
constexpr int kRowsPerWarp = kMT / kWarps;    // 8 accumulated rows per warp
constexpr int kTT = 64;                       // transactions per sub-tile
constexpr int kWordsPerLane = 3;              // int8x4 words of WB per lane
constexpr int kSliceWords = 32 * kWordsPerLane;
constexpr int kFS = 4 * kSliceWords;          // 384 columns per F slice
constexpr int kMaxWords = 384;                // packed words per row: F <= 12288

// Packed layout: column c is bit (c % 128) / 4 of word 4 * (c / 128) +
// c % 4, so a warp packs 128 columns with one byte load per lane and
// ballot.  S and B share the layout, so S & ~B word by word is the
// subset test of the 0/1 rows.
__global__ void pack_rows_kernel(const int8_t* __restrict__ X,
                                 uint32_t* __restrict__ out, int rows, int F,
                                 int words) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  for (int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); r < rows;
       r += warps) {
    const int8_t* row = X + (size_t)r * F;
    for (int q = 0; 4 * q < words; ++q) {
      uint32_t mine = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = 128 * q + 4 * lane + b;
        const uint32_t word = __ballot_sync(kFull, c < F && row[c] != 0);
        if (lane == b) mine = word;
      }
      if (lane < 4) out[(size_t)r * words + 4 * q + lane] = mine;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
level_counts_kernel(const uint32_t* __restrict__ b_packed,
                    const int8_t* __restrict__ WB,
                    const uint32_t* __restrict__ s_packed,
                    int32_t* __restrict__ out,
                    int T, int F, int M, int k1, int words, int t_per_block,
                    int wb_aligned) {
  // Row stride in shared memory: odd, so 16 rows at one word index fall
  // in 16 distinct banks.
  const int ws = words | 1;
  extern __shared__ uint32_t smem[];
  uint32_t* s_bits = smem;                    // [kMT][ws]
  uint32_t* b_bits = s_bits + kMT * ws;       // [kTT][ws]
  uint32_t* wb_tile = b_bits + kTT * ws;      // [kTT][kSliceWords]
  __shared__ unsigned long long contained[kMT];  // bit r: row t0+r holds m
  __shared__ unsigned long long any_row;
  __shared__ int s_pop[kMT];               // items per prefix row

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * kMT;
  const int f0 = blockIdx.y * kFS;
  const int t_begin = blockIdx.z * t_per_block;
  const int t_end = min(T, t_begin + t_per_block);

  for (int i = tid; i < kMT * words; i += kThreads) {
    const int r = i / words;
    const int w = i - r * words;
    s_bits[r * ws + w] =
        m0 + r < M ? s_packed[(size_t)(m0 + r) * words + w] : 0u;
  }
  __syncthreads();
  // Items per prefix row.  A row with fewer than k1 items never matches;
  // a block with no row of at least k1 items (e.g. all padding) is done.
  if (tid < kMT) {
    int p = 0;
    for (int w = 0; w < words; ++w) p += __popc(s_bits[tid * ws + w]);
    s_pop[tid] = p;
  }
  __syncthreads();
  const bool valid_row = tid < kMT && m0 + tid < M;
  // The caller's contract; a wider row would need an overlap count.
  assert(!(valid_row && s_pop[tid] > k1));
  if (!__syncthreads_or(valid_row && s_pop[tid] == k1)) return;

  int acc[kRowsPerWarp][4 * kWordsPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
    for (int i = 0; i < 4 * kWordsPerLane; ++i) acc[rr][i] = 0;

  // Membership micro-tile of this thread: prefix rows mg + 16 i and
  // sub-tile rows tg + 16 j, i, j in 0..3.  The 16 threads sharing mg are
  // one half-warp.
  const int mg = tid >> 4;
  const int tg = tid & 15;
  // Bit i: prefix row mg + 16 i is real and holds exactly k1 items.
  unsigned row_ok = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (m0 + mg + 16 * i < M && s_pop[mg + 16 * i] == k1) row_ok |= 1u << i;

  for (int t0 = t_begin; t0 < t_end; t0 += kTT) {
    __syncthreads();  // prefix bits staged / previous sub-tile consumed
    const int rows_here = min(kTT, t_end - t0);
    for (int i = tid; i < kTT * words; i += kThreads) {
      const int r = i / words;
      const int w = i - r * words;
      b_bits[r * ws + w] =
          r < rows_here ? b_packed[(size_t)(t0 + r) * words + w] : 0u;
    }
    __syncthreads();

    // Membership of the 4 x 4 micro-tile: overlap == k1 iff the row holds
    // exactly k1 items and all of them are in the transaction, i.e.
    // (S & ~B) == 0 — one LOP3 per word.
    uint32_t miss[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) miss[i][j] = 0;
#pragma unroll 4
    for (int w = 0; w < words; ++w) {
      uint32_t sv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = s_bits[(mg + 16 * i) * ws + w];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_bits[(tg + 16 * j) * ws + w];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) miss[i][j] |= sv[i] & ~bv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      unsigned long long mask = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tg + 16 * j;
        if (miss[i][j] == 0 && r < rows_here) mask |= 1ull << r;
      }
      if (!((row_ok >> i) & 1u)) mask = 0;
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) mask |= __shfl_xor_sync(kFull, mask, o);
      if (tg == 0) contained[mg + 16 * i] = mask;
    }
    __syncthreads();

    if (warp == 0) {
      unsigned long long a = contained[lane] | contained[lane + 32];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a |= __shfl_xor_sync(kFull, a, o);
      if (lane == 0) any_row = a;
    }
    __syncthreads();

    // Stage this block's F slice of WB, only for rows that hold at least
    // one of the block's prefixes.
    const unsigned long long rows = any_row;
    for (int r = warp; r < kTT; r += kWarps) {
      if (!((rows >> r) & 1ull)) continue;
      const int8_t* src = WB + (size_t)(t0 + r) * F;
#pragma unroll
      for (int i = 0; i < kWordsPerLane; ++i) {
        const int c = f0 + 128 * i + 4 * lane;
        uint32_t word = 0;
        if (wb_aligned) {
          if (c < F) word = *reinterpret_cast<const uint32_t*>(src + c);
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const uint32_t v = c + b < F ? (uint8_t)src[c + b] : 0u;
            word |= v << (8 * b);
          }
        }
        wb_tile[r * kSliceWords + 32 * i + lane] = word;
      }
    }
    __syncthreads();

    // Counting: warp-uniform walk over each owned prefix's contained rows.
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      unsigned long long cm = contained[warp + kWarps * rr];
      while (cm) {
        const int r = __ffsll((long long)cm) - 1;
        cm &= cm - 1;
#pragma unroll
        for (int i = 0; i < kWordsPerLane; ++i) {
          const uint32_t word = wb_tile[r * kSliceWords + 32 * i + lane];
#pragma unroll
          for (int b = 0; b < 4; ++b)
            acc[rr][4 * i + b] += (int)(int8_t)(word >> (8 * b));
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int m = m0 + warp + kWarps * rr;
    if (m >= M) continue;
#pragma unroll
    for (int i = 0; i < kWordsPerLane; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = f0 + 128 * i + 4 * lane + b;
        const int v = acc[rr][4 * i + b];
        if (c < F && v != 0) atomicAdd(out + (size_t)m * F + c, v);
      }
  }
}

}  // namespace

// B, WB: [T, F] int8; S: [M, F] int8; out: [M, F] int32, zero-filled;
// scratch: (T + M) * words uint32, words = 4 * ceil(F / 128) per packed
// row.  Launches the packing passes and the
// counting kernel on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int fa_level_counts(const void* B, const void* WB, const void* S,
                               void* out, void* scratch, int T, int F, int M,
                               int k1, void* stream) {
  if (T <= 0 || F <= 0 || M <= 0) return 0;
  const int words = 4 * ((F + 127) / 128);
  if (words > kMaxWords) return (int)cudaErrorInvalidValue;
  const int ws = words | 1;
  const size_t smem = (size_t)(kMT + kTT) * ws * sizeof(uint32_t) +
                      (size_t)kTT * kSliceWords * sizeof(uint32_t);
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaStream_t st = (cudaStream_t)stream;
  uint32_t* b_packed = (uint32_t*)scratch;
  uint32_t* s_packed = b_packed + (size_t)T * words;
  const int pack_blocks_b = (T + kWarps - 1) / kWarps;
  const int pack_blocks_s = (M + kWarps - 1) / kWarps;
  pack_rows_kernel<<<pack_blocks_b < 8 * sms ? pack_blocks_b : 8 * sms,
                     kThreads, 0, st>>>((const int8_t*)B, b_packed, T, F,
                                        words);
  pack_rows_kernel<<<pack_blocks_s < 8 * sms ? pack_blocks_s : 8 * sms,
                     kThreads, 0, st>>>((const int8_t*)S, s_packed, M, F,
                                        words);
  const int m_tiles = (M + kMT - 1) / kMT;
  const int f_tiles = (F + kFS - 1) / kFS;
  const int n_sub = (T + kTT - 1) / kTT;
  // Split T so that about four blocks per SM are in flight.
  const long long tiles = (long long)m_tiles * f_tiles;
  int splits = (int)((4LL * sms + tiles - 1) / tiles);
  splits = splits < 1 ? 1 : (splits > n_sub ? n_sub : splits);
  if (splits > 65535) splits = 65535;
  const int sub_per_block = (n_sub + splits - 1) / splits;
  splits = (n_sub + sub_per_block - 1) / sub_per_block;
  cudaError_t err = cudaFuncSetAttribute(
      level_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(m_tiles, f_tiles, splits);
  level_counts_kernel<<<grid, kThreads, smem, st>>>(
      b_packed, (const int8_t*)WB, s_packed, (int32_t*)out, T, F, M, k1,
      words, sub_per_block * kTT,
      F % 4 == 0 && (uintptr_t)WB % 4 == 0 ? 1 : 0);
  return (int)cudaGetLastError();
}
