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
// Two forms count, chosen per launch by the caller (ops/level_kernel.py
// `pick_form`, from the mine's min support and F; below).  Both share
// the schedule: one wave of persistent blocks takes work items (tile of
// prefix rows, F slice, T range) from a counter, tiles of only padding
// rows take no work, and each item adds its sums to `out` once, at its
// end.
//
// The packed form: what bounds it on the H100, and what the design does:
// - Two products.  Membership: each (prefix, transaction) pair is tested,
//   M x T pairs.  Counting: each contained pair adds its WB row, on CUDA
//   cores: its work is the contained pairs x F (3.16 M of the 359 M real
//   pairs at the T10I4D100K shape's k = 3), visited from warp-uniform
//   bit masks into register accumulators (a warp owns four prefix rows,
//   a lane 12 columns of each: 48 registers, no spills at 2 blocks/SM).
// - Membership, packed and word-sparse.  B is bit-packed once per launch
//   into 32-bit words, stored word-major ([F/32][T], so a warp reads 32
//   transactions' word with one 128-byte access).  Each prefix row is
//   reduced once per launch to its list of non-zero words (at most k1 of
//   them), so a pair costs one AND-NOT per listed word, and a warp tests
//   32 transactions at once, a ballot giving the contained mask.
// - Counting from packed rows.  WB = w (.) B gives each row one value:
//   the same first pass packs WB's non-zero bits and that value, so a
//   contained pair reads 3 words and a value, not F scattered bytes.  A
//   row whose non-zero values differ is flagged and read as bytes: exact
//   for any WB.
// - Memory waits off the critical path: sub-tiles of 32 G transactions
//   (512 at F = 384) stream through two shared-memory stages filled by
//   cp.async (B's packed words, the item's F slice of WB's packed bits
//   and the row values), one barrier per sub-tile.
// - Any F.  Up to kMaxStagedWords words (F <= 12,288) B is staged;
//   above, the membership reads each listed word of B from device memory
//   and G = 16.  Every index into the scratch is 64-bit.
//
// The function's own bound (both forms): B, WB and S read once, the
// counts written once, and 2 F operations per contained pair, at the
// 1,979 TOP/s int8 data-sheet rate: 0.041 ms (operations) at the
// MovieLens-shape launch [159,040 x 256], M = 8,192, 0.022 ms (bytes)
// at T10I4D100K's level 3 [77,280 x 384].
//
// The dense form (level_counts_dense): the counting is the int8 product
// common[M, T] . WB[T, F] on the tensor cores, whatever the share.
// - Its own roofline: 2 x (live rows) x T x F int8 operations, 0.25 ms
//   at the MovieLens-shape launch, 6,110 live rows of 8,192: it runs
//   the product for the pairs that are not contained too.  The
//   membership adds M x T x k1 / 32 ANDs, and WB is read from L2 once
//   per 128-row tile (about 2.2 GB there).
// - Membership stays packed, sliced by transaction: bit i of word (f, w)
//   is B[32 w + i, f], so lane (row, 32-transaction group) ANDs the
//   row's k1 item words: 32 pairs per instruction and item, no ballot.
//   The contained bits expand to the 0/1 int8 tile common[128][128] in
//   shared memory (32 bytes a lane).
// - Counting: int8 mma.sync.m16n8k32 (built; wgmma is not), A = common
//   and B = WB from shared memory by ldmatrix.  The .col operand is
//   K-major and K is T, so WB is transposed once per launch into
//   [Fp][Tp] (T contiguous), in the same first pass that slices B:
//   40.7 MB written at the MovieLens shape, the pass 0.075-0.080 ms of
//   the launch's 0.93-1.0 ms of device time.  A warp holds
//   32 rows x 64 columns of int32 accumulators over the item's T range;
//   16 warps cover 128 rows x 256 columns.
// - Loads overlap compute: sub-tiles of 128 transactions stream through
//   a ring of three shared-memory stages (B's bits of every column, the
//   F slice of WB transposed) by cp.async two sub-tiles ahead; the
//   common tile is double-buffered, one barrier per sub-tile.  Work
//   items run T-major, so the blocks at work share WB's T range in L2.
// - Any F: 256-column slices; above Fp = 1,024 B's bits are read from
//   device memory.  k1 may exceed 127 (the overlap is never formed).
//
// When each form wins (H100 80GB HBM3 at 700 W, chip_smoke.py):
// - T10I4D100K shape, pair shares 0.3-0.8 %: the packed form, 3.46 ms
//   over the 7 launches k = 4..10 against 4.26 ms dense (dense wins
//   only at k = 3, 1.02 against 1.12 ms, off the main path).
// - MovieLens shape, pair shares 12-19 %: the dense form, 1.27 ms at the
//   heaviest launch (k = 5) against 18.0 ms packed and 16.6 ms for two
//   torch._int_mm, 31x its bound; 5.35 ms over k = 4..8 against 60.6.
// - The crossover, from share sweeps at M = 8,192, k1 = 4: the forms
//   are equal near a 0.25 % share at [159,040 x 256], 1.05 % at
//   [77,280 x 384], under 0.1 % at [77,280 x 512] and 0.6 % at
//   [77,280 x 768].  Each form redoes its work per F slice (256
//   columns dense, 384 packed), so `pick_form` takes the dense form
//   from a min support of 0.8 % x r - 0.55 %, r the dense form's slices
//   over the packed form's.
// - An earlier design put the membership itself on the tensor cores
//   (int8 mma.sync of S and B tiles, the overlap compared with k1 in
//   registers): about 5.5 ms against the packed form's 1.07 ms at the
//   T10I4D100K k = 3 launch.  The dense form keeps the membership packed
//   and puts only the counting there.
// Ragged T, M and F are masked in the kernels, and k1 is an int32, so
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
  uint32_t* bv;         // dense form: [Fp][Tp / 32] B's bits sliced by
                        // transaction: bit i of (f, w) = B[32 w + i, f]
  int8_t* wbt;          // dense form: [Fp][Tp] WB transposed, T contiguous
  int32_t* ilist;       // dense form: [M][Li] the items of each row
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

// The dense form's operands, in one pass over B and WB: WB transposed,
// wbt[f][t] = WB[t, f], and B's bits sliced by transaction, bv[f][w] bit
// i = B[32 w + i, f] != 0, for f < Fp (F rounded up to 64) and t < Tp,
// zero past F and T.  A block moves a 64 x 64 tile of each through
// shared memory: 16 bytes a thread in along F; out, 16 bytes of WB a
// thread along T and one 32-transaction word of B's bits.
__global__ void prep_dense_kernel(const int8_t* __restrict__ B,
                                  const int8_t* __restrict__ WB, Scratch sc,
                                  int T, int F, int Tp, int Fp,
                                  int aligned16) {
  __shared__ __align__(16) int8_t wb_s[64][80];  // [f][t]
  __shared__ __align__(16) int8_t b_s[64][80];
  const int i = threadIdx.x;
  const int tw = Tp / 32;
  for (long long blk = blockIdx.x; blk < (long long)(Tp / 64) * (Fp / 64);
       blk += gridDim.x) {
    const int t0 = (int)(blk / (Fp / 64)) * 64;
    const int f0 = (int)(blk % (Fp / 64)) * 64;
    {
      const int tl = i / 4, fq = 16 * (i % 4);
      const int t = t0 + tl, f = f0 + fq;
      uint32_t v[4] = {0u, 0u, 0u, 0u}, u[4] = {0u, 0u, 0u, 0u};
      if (aligned16 && t < T && f + 16 <= F) {
        const uint4 q = *reinterpret_cast<const uint4*>(WB + (size_t)t * F + f);
        const uint4 r = *reinterpret_cast<const uint4*>(B + (size_t)t * F + f);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        u[0] = r.x; u[1] = r.y; u[2] = r.z; u[3] = r.w;
      } else if (t < T) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (f + j < F) {
            v[j / 4] |= (uint32_t)(uint8_t)WB[(size_t)t * F + f + j]
                        << (8 * (j % 4));
            u[j / 4] |= (uint32_t)(uint8_t)B[(size_t)t * F + f + j]
                        << (8 * (j % 4));
          }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        wb_s[fq + j][tl] = (int8_t)(v[j / 4] >> (8 * (j % 4)));
        b_s[fq + j][tl] = (int8_t)(u[j / 4] >> (8 * (j % 4)));
      }
    }
    __syncthreads();
    {
      const int fl = i / 4, tq = 16 * (i % 4);
      *reinterpret_cast<uint4*>(sc.wbt + (size_t)(f0 + fl) * Tp + t0 + tq) =
          *reinterpret_cast<const uint4*>(&wb_s[fl][tq]);
    }
    if (i < 128) {
      const int fl = i / 2, g = i % 2;
      const uint4* q = reinterpret_cast<const uint4*>(&b_s[fl][32 * g]);
      const uint4 q0 = q[0], q1 = q[1];
      const uint32_t w[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
      uint32_t bits = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t nz = __vcmpne4(w[k], 0u);
        bits |= (((nz & 0x01010101u) * 0x01020408u) >> 24 & 0xfu) << (4 * k);
      }
      sc.bv[(size_t)(f0 + fl) * tw + t0 / 32 + g] = bits;
    }
    __syncthreads();
  }
}

// The dense form's rows: each prefix row -> its items (the first Li kept),
// its item count checked against k1; rows of exactly k1 items are live
// (nw = k1, else -1), and their tiles of tile_rows rows are listed once
// each.
__global__ void prep_items_kernel(const int8_t* __restrict__ S, Scratch sc,
                                  int M, int F, int Li, int k1,
                                  int tile_rows) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  for (int m = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); m < M;
       m += warps) {
    const int8_t* row = S + (size_t)m * F;
    int pop = 0;
    for (int c0 = 0; c0 < F; c0 += 32) {
      const int c = c0 + lane;
      const bool on = c < F && row[c] != 0;
      const uint32_t word = __ballot_sync(kFull, on);
      const int pos = pop + __popc(word & ((1u << lane) - 1u));
      if (on && pos < Li) sc.ilist[(size_t)m * Li + pos] = c;
      pop += __popc(word);
    }
    // The caller's contract; a wider row would need an overlap count.
    assert(pop <= k1);
    const bool live = pop == k1;
    if (lane == 0) {
      sc.nw[m] = live ? pop : -1;
      if (live && atomicCAS(sc.tile_flag + m / tile_rows, 0, 1) == 0)
        sc.tile_list[atomicAdd(sc.n_live, 1)] = m / tile_rows;
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
// (tile, F slice of fs columns, T range); the T ranges are cut so that
// there are about `per_block` items per block, each of at least `min_sub`
// sub-tiles of tt transactions (or all of T); in T-major order (the
// split outer) or tile-major.
__device__ bool next_item(const Scratch& sc, int T, int F, int fs, int tt,
                          int per_block, int min_sub, bool t_major,
                          Item* it) {
  __shared__ unsigned long long taken;
  __syncthreads();  // the previous item's shared data are consumed
  if (threadIdx.x == 0) taken = atomicAdd(sc.counter, 1ull);
  __syncthreads();
  const long long n_live = *sc.n_live;
  const int f_tiles = (F + fs - 1) / fs;
  const long long n_sub = (T + tt - 1) / tt;
  const long long tiles = n_live * f_tiles;
  if (tiles == 0) return false;
  const long long most = (n_sub + min_sub - 1) / min_sub;
  long long splits = ((long long)per_block * gridDim.x + tiles - 1) / tiles;
  splits = splits < 1 ? 1 : (splits > most ? most : splits);
  const long long sub_per = (n_sub + splits - 1) / splits;
  splits = (n_sub + sub_per - 1) / sub_per;
  if ((long long)taken >= tiles * splits) return false;
  // T-major: the blocks at work at one time read the same T ranges of
  // the operands, which then stay in L2.
  const long long q = t_major ? (long long)taken % tiles
                              : (long long)taken / splits;
  const long long split = t_major ? (long long)taken / tiles
                                  : (long long)taken - q * splits;
  it->tile = sc.tile_list[q / f_tiles];
  it->f0 = (int)(q % f_tiles) * fs;
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
  while (next_item(sc, T, F, kFS, kTT, kItemsPerBlock, 1, false, &it)) {
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

// ---- The dense form: membership packed, counting on the tensor cores.

constexpr int kDThreads = 512;      // 16 warps: 4 (rows) x 4 (columns)
constexpr int kDMT = 128;           // prefix rows per tile (4 warps x 32)
constexpr int kDFS = 256;           // columns per F slice (4 warps x 64)
constexpr int kDTC = 128;           // transactions per sub-tile: 4 k32 steps
constexpr int kDGroups = kDTC / 32;
constexpr int kDRow = kDTC + 16;    // shared row pitch in bytes: the eight
                                    // rows of an ldmatrix fall in distinct
                                    // banks
constexpr int kDStages = 3;
constexpr int kDStagedItems = 1024; // B's bits staged in shared memory up to
                                    // Fp = 1,024
constexpr int kDItemCap = 8;        // items per row kept in shared memory
constexpr int kDItemsPerBlock = 4;
constexpr int kDMinSub = 8;         // sub-tiles per item at least
// Membership: 8 rows x 4 groups a warp cover the tile's sub-tile.
static_assert(kDThreads / 32 * 8 == kDMT && kDTC == 128, "membership map");

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a (16 x 32, 0/1) . b (32 x 8, WB), int8 in, int32 accumulators.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The dense form.  An item is (128-row tile, 256-column F slice, T
// range); its sub-tiles of 128 transactions run through a ring of three
// shared-memory stages, each holding B's bits of the sub-tile (every
// column, transaction-sliced: 16 bytes a column) and the F slice of WB
// transposed (256 rows of 128 bytes), filled by cp.async two sub-tiles
// ahead.  Between two barriers a block (1) counts sub-tile s:
// common . WB by int8 mma.sync.m16n8k32 (A and B from shared memory by
// ldmatrix, WB K-major as the .col operand wants it), each warp holding
// 32 rows x 64 columns of int32 accumulators over the item's T range;
// and (2) tests sub-tile s + 1's membership: lane (row, group) ANDs the
// row's k1 item words of its 32 transactions, expands the contained bits
// to bytes and writes them as 32 bytes of the 0/1 int8 tile
// common[128][128] (two tiles, one read while the other is written).
// The item's sums are added to `out` once, at its end.
template <bool kStageB>
__global__ void __launch_bounds__(kDThreads, 1)
level_counts_dense(int32_t* __restrict__ out, Scratch sc, int T, int F,
                   int M, int Tp, int Fp, int Li) {
  extern __shared__ __align__(16) uint8_t dsm[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2;  // rows 32 wm .. 32 wm + 31 of the tile
  const int wn = warp & 3;   // columns 64 wn .. 64 wn + 63 of the slice
  const int mr = 8 * warp + (lane >> 2);  // membership: the lane's row
  const int mg = lane & 3;                // and its 32-transaction group
  const int tw = Tp / 32;
  const int bv_bytes = kStageB ? 4 * kDGroups * Fp : 0;
  const int stage_bytes = bv_bytes + kDFS * kDRow;
  uint8_t* common = dsm + kDStages * stage_bytes;
  __shared__ int items_s[kDMT][kDItemCap + 1];  // + 1: the 8 rows a warp
                                                // reads at once, 8 banks
  __shared__ int nw_s[kDMT];
  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;
  Item it;
  while (next_item(sc, T, F, kDFS, kDTC, kDItemsPerBlock, kDMinSub, true,
                   &it)) {
    const int m_base = it.tile * kDMT;
    for (int i = threadIdx.x; i < kDMT * kDItemCap; i += kDThreads) {
      const int r = i / kDItemCap, j = i % kDItemCap;
      const int m = m_base + r;
      if (j == 0) nw_s[r] = m < M ? sc.nw[m] : -1;
      if (m < M && j < Li) items_s[r][j] = sc.ilist[(size_t)m * Li + j];
    }
    const int n_sub = (it.t_end - it.t_begin + kDTC - 1) / kDTC;
    const int f_rows = Fp - it.f0 < kDFS ? Fp - it.f0 : kDFS;
    auto stage_in = [&](int s) {
      if (s < n_sub) {
        uint8_t* dst = dsm + (s % kDStages) * stage_bytes;
        const int t0 = it.t_begin + s * kDTC;
        if (kStageB) {
          for (int i = threadIdx.x; i < Fp; i += kDThreads)
            cp_async16(dst + 16 * i, sc.bv + (size_t)i * tw + t0 / 32);
        }
        for (int i = threadIdx.x; i < f_rows * (kDTC / 16); i += kDThreads) {
          const int r = i / (kDTC / 16);
          const int q = i - r * (kDTC / 16);
          cp_async16(dst + bv_bytes + r * kDRow + 16 * q,
                     sc.wbt + (size_t)(it.f0 + r) * Tp + t0 + 16 * q);
        }
      }
      cp_async_commit();
    };
    // Sub-tile s's contained bits -> common[s & 1], 32 bytes a lane.
    auto member = [&](int s) {
      const uint32_t* bv = reinterpret_cast<const uint32_t*>(
          dsm + (s % kDStages) * stage_bytes);
      const int t0 = it.t_begin + s * kDTC;
      const int nw = nw_s[mr];
      uint32_t x = nw < 0 ? 0u : valid_bits(t0 + 32 * mg, it.t_end);
      const int* lst = sc.ilist + (size_t)(m_base + mr) * Li;
      for (int j = 0; j < nw && x != 0; ++j) {
        const int item = j < kDItemCap ? items_s[mr][j] : __ldg(lst + j);
        x &= kStageB ? bv[kDGroups * item + mg]
                     : __ldg(sc.bv + (size_t)item * tw + t0 / 32 + mg);
      }
      uint32_t w[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        w[q] = (((x >> (4 * q)) & 0xfu) * 0x00204081u) & 0x01010101u;
      uint4* dst = reinterpret_cast<uint4*>(common + (s & 1) * kDMT * kDRow +
                                            mr * kDRow + 32 * mg);
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
    };
    // acc += common[s & 1][32 wm.., :] . WB[sub-tile s, 64 wn..]
    auto count = [&](int s) {
      const uint8_t* wbs = dsm + (s % kDStages) * stage_bytes + bv_bytes;
      const uint8_t* cm = common + (s & 1) * kDMT * kDRow;
#pragma unroll
      for (int kk = 0; kk < kDTC / 32; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldmatrix_x4(a[i], cm + (32 * wm + 16 * i + (lane & 7) +
                                  8 * ((lane >> 3) & 1)) * kDRow +
                                32 * kk + 16 * (lane >> 4));
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t b[4];
          ldmatrix_x4(b, wbs + (64 * wn + 16 * jp + (lane & 7) +
                                8 * (lane >> 4)) * kDRow +
                             32 * kk + 16 * ((lane >> 3) & 1));
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_s8(acc[i][2 * jp], a[i], b[0], b[1]);
            mma_s8(acc[i][2 * jp + 1], a[i], b[2], b[3]);
          }
        }
      }
    };
#pragma unroll
    for (int s = 0; s < kDStages - 1; ++s) stage_in(s);
    cp_async_wait<kDStages - 2>();
    __syncthreads();  // stage 0 is in; the tile's items are read
    member(0);
    const bool counts = 64 * wn < f_rows;  // the warp's columns exist
    for (int s = 0; s < n_sub; ++s) {
      cp_async_wait<kDStages - 3>();
      __syncthreads();  // stage s + 1 is in; common[s & 1] is whole;
                        // sub-tile s - 1 is counted
      stage_in(s + kDStages - 1);
      // The MMAs first: the membership's loads and ALU work issue while
      // the tensor cores drain them.
      if (counts) count(s);
      if (s + 1 < n_sub) member(s + 1);
    }
    // The item's sums, added once; accumulator q of n-tile j holds row
    // lane / 4 (+ 8 for q >= 2), column 2 (lane % 4) + q % 2.
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int m = m_base + 32 * wm + 16 * i + (lane >> 2) + 8 * (q >> 1);
          const int c = it.f0 + 64 * wn + 8 * j + 2 * (lane & 3) + (q & 1);
          const int v = acc[i][j][q];
          if (v != 0 && m < M && c < F) atomicAdd(out + (size_t)m * F + c, v);
          acc[i][j][q] = 0;
        }
  }
}

template <typename Kernel>
int persistent_blocks(Kernel kernel, size_t smem, int threads, int* blocks) {
  int dev = 0, sms = 132, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
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
      persistent_blocks(level_counts_packed<G, kStageB>, smem, kThreads,
                        &blocks);
  if (err) return err;
  level_counts_packed<G, kStageB><<<blocks, kThreads, smem, st>>>(
      (const int8_t*)WB, (int32_t*)out, sc, T, F, M, Tp, L, aligned);
  return 0;
}

template <bool kStageB>
int launch_dense(void* out, const Scratch& sc, int T, int F, int M, int Tp,
                 int Fp, int Li, cudaStream_t st) {
  const size_t smem =
      (size_t)kDStages * ((kStageB ? 4 * kDGroups * Fp : 0) + kDFS * kDRow) +
      2 * kDMT * kDRow;
  int blocks = 0;
  const int err = persistent_blocks(level_counts_dense<kStageB>, smem,
                                    kDThreads, &blocks);
  if (err) return err;
  level_counts_dense<kStageB><<<blocks, kDThreads, smem, st>>>(
      (int32_t*)out, sc, T, F, M, Tp, Fp, Li);
  return 0;
}

}  // namespace


// The two forms of the counting (ops/level_kernel.py `FORMS`).
enum Form { kPacked = 0, kDense = 1 };

// Bytes of scratch fa_level_counts needs (16-byte aligned by the caller).
extern "C" long long fa_level_counts_scratch(int T, int F, int M, int k1,
                                             int form) {
  const long long words = (F + 31) / 32;
  const long long tp = ((long long)T + kTPad - 1) / kTPad * kTPad;
  const long long tiles = ((long long)M + kMT - 1) / kMT;
  long long n;
  if (form == kDense) {
    const long long fp = ((long long)F + 63) / 64 * 64;
    const long long li = k1 < 1 ? 1 : k1;
    // B's bits by transaction, WB transposed, item lists, row counts
    n = fp * tp / 8 + fp * tp + 4 * (long long)M * li + 4LL * M;
  } else {
    const long long L = k1 < 1 ? 1 : (k1 < words ? k1 : words);
    const long long wstride = (words + 3) / 4 * 4;
    // packed B, packed WB (plus one F slice read past the last row), WB
    // values, row lists, word counts
    n = 4 * words * tp + 4 * (wstride * tp + kSliceWords) + 4 * tp +
        8 * (long long)M * L + 4LL * M;
  }
  // the tile list and the zeroed block, each part rounded to 16 bytes
  n += 8 * tiles + 160;
  return (n + 15) / 16 * 16;
}

// B, WB: [T, F] int8; S: [M, F] int8; out: [M, F] int32, zero-filled;
// scratch: fa_level_counts_scratch bytes; form: kPacked or kDense.
// Launches the preparation passes and the counting kernel of that form
// on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int fa_level_counts(const void* B, const void* WB, const void* S,
                               void* out, void* scratch, int T, int F, int M,
                               int k1, int form, void* stream) {
  if (form != kPacked && form != kDense) return (int)cudaErrorInvalidValue;
  if (T <= 0 || F <= 0 || M <= 0) return 0;
  const bool dense = form == kDense;
  const int words = (F + 31) / 32;
  cudaStream_t st = (cudaStream_t)stream;
  const int Tp = (T + kTPad - 1) / kTPad * kTPad;
  const int Fp = (F + 63) / 64 * 64;
  const int L = k1 < 1 ? 1 : (k1 < words ? k1 : words);
  const int Li = k1 < 1 ? 1 : k1;
  const int tile_rows = dense ? kDMT : kMT;
  const int tiles = (M + tile_rows - 1) / tile_rows;
  // Layout: the zeroed block first (tile flags, n_live, counter), then
  // the rest, each part 16-byte aligned.
  char* p = (char*)scratch;
  auto take = [&p](size_t bytes) {
    char* q = p;
    p += (bytes + 15) / 16 * 16;
    return q;
  };
  Scratch sc{};
  sc.words = words;
  sc.wstride = (words + 3) / 4 * 4;
  sc.counter = (unsigned long long*)p;
  sc.n_live = (int32_t*)(p + 8);
  sc.tile_flag = (int32_t*)(p + 16);
  const size_t zeroed = 16 + (size_t)4 * tiles;
  take(zeroed);
  if (dense) {
    sc.bv = (uint32_t*)take((size_t)Fp * Tp / 8);
    sc.wbt = (int8_t*)take((size_t)Fp * Tp);
    sc.ilist = (int32_t*)take((size_t)4 * M * Li);
  } else {
    sc.bp = (uint32_t*)take((size_t)4 * words * Tp);
    sc.wm = (uint32_t*)take((size_t)4 * ((size_t)sc.wstride * Tp + kSliceWords));
    sc.wv = (int32_t*)take((size_t)4 * Tp);
    sc.slist = (uint2*)take((size_t)8 * M * L);
  }
  sc.nw = (int32_t*)take((size_t)4 * M);
  sc.tile_list = (int32_t*)take((size_t)4 * tiles);
  cudaError_t err = cudaMemsetAsync(scratch, 0, zeroed, st);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int a4 = F % 4 == 0 && (uintptr_t)B % 4 == 0 && (uintptr_t)WB % 4 == 0;
  const int a16 =
      F % 16 == 0 && (uintptr_t)B % 16 == 0 && (uintptr_t)WB % 16 == 0;
  const int row_blocks = (M + kWarps - 1) / kWarps;
  const int prep_grid = row_blocks < 8 * sms ? row_blocks : 8 * sms;
  int rc = 0;
  if (dense) {
    const long long t_blocks = (long long)(Tp / 64) * (Fp / 64);
    prep_dense_kernel<<<t_blocks < 16 * sms ? (int)t_blocks : 16 * sms,
                        kThreads, 0, st>>>((const int8_t*)B,
                                           (const int8_t*)WB, sc, T, F, Tp,
                                           Fp, a16);
    prep_items_kernel<<<prep_grid, kThreads, 0, st>>>(
        (const int8_t*)S, sc, M, F, Li, k1, tile_rows);
    rc = Fp > kDStagedItems
             ? launch_dense<false>(out, sc, T, F, M, Tp, Fp, Li, st)
             : launch_dense<true>(out, sc, T, F, M, Tp, Fp, Li, st);
    if (rc) return rc;
    return (int)cudaGetLastError();
  }
  const int aligned = F % 4 == 0 && (uintptr_t)WB % 4 == 0 ? 1 : 0;
  err = cudaMemsetAsync(sc.wv, 0, (size_t)4 * Tp, st);
  if (err != cudaSuccess) return (int)err;
  const int pack_x = (Tp + kThreads - 1) / kThreads;
  pack_kernel<<<dim3(pack_x < 2 * sms ? pack_x : 2 * sms,
                     sc.wstride < kMaxGridY ? sc.wstride : kMaxGridY),
                kThreads, 0, st>>>((const int8_t*)B, (const int8_t*)WB, sc, T,
                                   F, words, Tp, a4, a16);
  prep_rows_kernel<<<prep_grid, kThreads, 0, st>>>((const int8_t*)S, sc, M, F,
                                                   words, L, k1);
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
