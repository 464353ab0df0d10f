// Native preprocessing: tokenize + item count + rank + basket dedup in one
// pass over the raw bytes (reference components C3/C4, FastApriori.scala:
// 52-85 — there they are Spark shuffle passes; here a single C++ scan).
//
// Semantics contract (must match the Python path of
// fastapriori_tpu_torch/preprocess.py exactly; tests/test_torch_native.py
// enforces equality, array for array):
//   - lines split on '\n'; each line trimmed then split on ASCII whitespace
//     runs; an empty (trimmed) line yields ONE empty token (Java
//     String.split("\\s+") semantics, Utils.scala:21);
//   - item occurrence counts: every token occurrence counts, duplicates
//     within a line included (FastApriori.scala:55);
//   - minCount = ceil(min_support * raw_line_count) (FastApriori.scala:39);
//   - frequent items sorted by (-count, numeric-if-integer asc, token asc)
//     (utils/order.py item_sort_key), dense ranks 0..F-1;
//   - baskets: per line, frequent tokens -> ranks, dedup within line, drop
//     size <= 1, dedupe identical baskets with int32 multiplicity
//     (FastApriori.scala:66-79); first-seen order.
//
// Three entry points share the helpers below (ONE tokenizer, ONE dedup):
//   - fa_preprocess_buffer: the whole pipeline for a single host;
//   - fa_count_buffer + fa_compress_with_ranks: the split phases of a
//     multi-host SHARDED ingest — each process counts and compresses only its own byte range against
//     globally merged rank tables.  Identical baskets in different shards
//     stay separate rows with their own multiplicities; weighted counts
//     are unaffected, so cross-shard dedup is unnecessary.
//
// C ABI only (loaded via ctypes): fa_preprocess_buffer / fa_count_buffer /
// fa_compress_with_ranks / fa_fill_packed_bitmap / fa_free_*, and
// fa_format_lines, which lays out the output artifacts (io/writer.py).

#include <algorithm>
#include <atomic>
#include <cctype>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <new>
#include <string>
#include <thread>
#include <string_view>
#include <system_error>
#include <unordered_map>
#include <vector>

#if defined(__AVX512BW__) && defined(__BMI__)
#define FA_HAVE_AVX512 1
#include <immintrin.h>
#endif

#ifdef __linux__
#include <sys/mman.h>
#endif

namespace {
// Ask the kernel for transparent huge pages on a large heap range (THP
// policy "madvise" needs the hint): the GB-scale capture/arena buffers
// otherwise fault in ~4 KB at a time — ~220K soft faults (~0.2 s) per
// GB on first touch.  Best-effort; errors are ignored.
inline void advise_hugepages(void* ptr, size_t bytes) {
#if defined(__linux__) && defined(MADV_HUGEPAGE)
  if (!ptr || bytes < (8u << 20)) return;
  uintptr_t lo = (reinterpret_cast<uintptr_t>(ptr) + 4095) & ~uintptr_t(4095);
  uintptr_t hi =
      (reinterpret_cast<uintptr_t>(ptr) + bytes) & ~uintptr_t(4095);
  if (hi > lo) madvise(reinterpret_cast<void*>(lo), hi - lo, MADV_HUGEPAGE);
#else
  (void)ptr;
  (void)bytes;
#endif
}
}  // namespace

// FA_NATIVE_TIMING=1 prints per-phase wall times to stderr (diagnostics
// for the single-core preprocess budget; no effect on results).
namespace {
struct PhaseTimer {
  bool on;
  std::chrono::steady_clock::time_point t0;
  PhaseTimer() : on(std::getenv("FA_NATIVE_TIMING") != nullptr) {
    t0 = std::chrono::steady_clock::now();
  }
  void mark(const char* name) {
    if (!on) return;
    auto t1 = std::chrono::steady_clock::now();
    std::fprintf(
        stderr, "fa_native[%s]: %.3f s\n", name,
        std::chrono::duration<double>(t1 - t0).count());
    t0 = t1;
  }
};
}  // namespace

namespace {

// Byte classes for the tokenizer hot loop: one table load replaces the
// six-way whitespace comparison chain per byte.  bit0 = Java \s
// (ASCII ws the tokenizer splits on), bit1 = decimal digit.
constexpr uint8_t kWs = 1, kDigit = 2;
struct ByteClass {
  uint8_t t[256] = {};
  constexpr ByteClass() {
    t[' '] = t['\t'] = t['\n'] = t['\v'] = t['\f'] = t['\r'] = kWs;
    for (int c = '0'; c <= '9'; ++c) t[c] = kDigit;
  }
};
constexpr ByteClass kByteClass;

inline bool is_ws(unsigned char c) { return kByteClass.t[c] & kWs; }

// Dense fast path: most datasets use small decimal item ids.  A token in
// CANONICAL decimal form (single "0", or leading digit 1-9, all digits, at
// most 7 of them) maps to a slot in a dense array, bypassing the string
// hash maps.  Canonical-form only: "007", "+7" and "7" are DIFFERENT
// tokens for counting purposes and must not collide.
constexpr int64_t kDenseCap = 10'000'000;  // ids 0..9,999,999 (<= 7 digits)

inline int64_t fast_id(std::string_view s) {
  size_t n = s.size();
  if (n == 0 || n > 7) return -1;
  unsigned char c0 = static_cast<unsigned char>(s[0]) - '0';
  if (c0 > 9 || (c0 == 0 && n > 1)) return -1;  // non-digit or leading zero
  int64_t v = c0;
  for (size_t i = 1; i < n; ++i) {
    unsigned char c = static_cast<unsigned char>(s[i]) - '0';
    if (c > 9) return -1;
    v = v * 10 + c;
  }
  return v;
}

// Matches Python int(token) on ASCII: optional sign, all digits.  Python
// ints are arbitrary precision, so the value is kept as a normalized
// (negative, digits-without-leading-zeros) pair and compared by
// (sign, magnitude-length, magnitude-lexical) — exact for any size.
struct BigInt {
  bool negative = false;
  std::string_view digits;  // no leading zeros; empty means 0
};

bool parse_int(std::string_view s, BigInt* out) {
  if (s.empty()) return false;
  size_t i = 0;
  bool neg = false;
  if (s[0] == '+' || s[0] == '-') {
    neg = s[0] == '-';
    if (s.size() == 1) return false;
    i = 1;
  }
  size_t first = i;
  for (; i < s.size(); ++i) {
    if (s[i] < '0' || s[i] > '9') return false;
  }
  while (first < s.size() - 1 && s[first] == '0') ++first;
  std::string_view digits = s.substr(first);
  if (digits == "0") digits = std::string_view();
  out->negative = neg && !digits.empty();  // -0 == 0
  out->digits = digits;
  return true;
}

// v < w as integers.
bool bigint_less(const BigInt& v, const BigInt& w) {
  if (v.negative != w.negative) return v.negative;
  bool less;
  if (v.digits.size() != w.digits.size()) {
    less = v.digits.size() < w.digits.size();
  } else {
    less = v.digits < w.digits;
  }
  return v.negative ? (v.digits != w.digits && !less) : less;
}

// ---- shared scan machinery (ONE copy for all three entry points) -----

// Split on '\n' (last line may lack it), trim with Java String.trim
// semantics (chars <= 0x20), call fn(trimmed_line) per line.
template <class Fn>
inline void for_each_trimmed_line(std::string_view buf, Fn&& fn) {
  size_t pos = 0;
  while (pos <= buf.size()) {
    size_t nl = buf.find('\n', pos);
    size_t end = (nl == std::string_view::npos) ? buf.size() : nl;
    if (nl == std::string_view::npos && pos == buf.size()) break;
    std::string_view line = buf.substr(pos, end - pos);
    size_t b = 0, e = line.size();
    while (b < e && static_cast<unsigned char>(line[b]) <= 0x20) ++b;
    while (e > b && static_cast<unsigned char>(line[e - 1]) <= 0x20) --e;
    fn(line.substr(b, e - b));
    if (nl == std::string_view::npos) break;
    pos = nl + 1;
  }
}

// Tokenize one trimmed NON-EMPTY line on whitespace runs; per token call
// fn(token_view, dense_id_or_minus1).  The canonical-decimal value
// accumulates during the walk, so classification costs no second scan;
// semantics identical to splitting then testing fast_id().  (Empty lines
// are the caller's business: Java split("") yields one empty token.)
template <class Fn>
inline void for_each_token(std::string_view line, Fn&& fn) {
  const char* p = line.data();
  const char* end = p + line.size();
  while (p < end) {
    while (p < end && is_ws(static_cast<unsigned char>(*p))) ++p;
    if (p >= end) break;
    const char* start = p;
    int64_t v = 0;
    bool digits_only = true;
    while (p < end) {
      const uint8_t cls = kByteClass.t[static_cast<unsigned char>(*p)];
      if (cls & kWs) break;
      if (!(cls & kDigit)) {
        digits_only = false;
      } else if (p - start < 7) {  // beyond 7 digits: non-dense anyway
        v = v * 10 + (static_cast<unsigned char>(*p) - '0');
      }
      ++p;
    }
    size_t n = static_cast<size_t>(p - start);
    bool dense = digits_only && n <= 7 && !(start[0] == '0' && n > 1);
    fn(std::string_view(start, n), dense ? v : -1);
  }
}

// Malloc-backed growable int32 buffer whose ownership can transfer into
// a result struct with NO copy (the dedup arena is ~0.6 GB at Webdocs
// scale and the marshal memcpy alone was ~2.5 s on a single-core host).
struct I32Buf {
  int32_t* p = nullptr;
  size_t n = 0, cap = 0;
  bool reserve(size_t want) {
    if (want <= cap) return true;
    size_t nc = cap ? cap * 2 : (1u << 20);
    while (nc < want) nc *= 2;
    auto* np_ = static_cast<int32_t*>(std::realloc(p, nc * sizeof(int32_t)));
    if (!np_) return false;
    p = np_;
    cap = nc;
    advise_hugepages(p, nc * sizeof(int32_t));
    return true;
  }
  bool append(const int32_t* src, size_t k) {
    if (!reserve(n + k)) return false;
    std::memcpy(p + n, src, k * sizeof(int32_t));
    n += k;
    return true;
  }
  // std::vector-style accessors for the pass-1 token capture (which
  // uses this buffer for its UNINITIALIZED growth: a value-initializing
  // vector resize would memset the ~1 GB webdocs-scale capture just to
  // overwrite it).  push_back matches the vector's OOM behavior.
  inline void push_back(int32_t v) {
    if (n == cap && !reserve(n + 1)) throw std::bad_alloc();
    p[n++] = v;
  }
  size_t size() const { return n; }
  int32_t operator[](size_t i) const { return p[i]; }
  void free_buf() {
    std::free(p);
    p = nullptr;
    n = cap = 0;
  }
};

// Distinct-basket accumulator: open-addressing index over (hash, arena
// slice) — no per-basket heap node, no rehash-time key copies; the final
// marshal hands the arena over pointer-for-pointer.  Insertion order =
// first-seen order (FastApriori.scala:74 zipWithIndex over the deduped
// RDD).
struct BasketDeduper {
  I32Buf arena;                  // concatenated sorted rank lists
  std::vector<int64_t> b_off;    // [t] arena offset per basket
  std::vector<int32_t> b_len;    // [t]
  std::vector<int32_t> b_weight; // [t] multiplicity
  std::vector<uint64_t> b_hash;  // [t] cached for table growth
  size_t table_size = 1 << 12;   // power of two
  std::vector<int64_t> table = std::vector<int64_t>(1 << 12, -1);


  void grow_table() {
    table_size *= 2;
    std::fill(table.begin(), table.end(), -1);
    table.resize(table_size, -1);
    const size_t mask = table_size - 1;
    for (size_t id = 0; id < b_off.size(); ++id) {
      size_t slot = static_cast<size_t>(b_hash[id]) & mask;
      while (table[slot] != -1) slot = (slot + 1) & mask;
      table[slot] = static_cast<int64_t>(id);
    }
  }

  // Probe/commit for a rank list ALREADY written at the arena cursor
  // (the fused bitset walk in insert_from_bitset writes there
  // directly).  On a new basket the cursor advances; on a duplicate it
  // stays put — an implicit rollback of the speculative write.
  void commit_at_cursor(size_t n, uint64_t h) {
    const size_t mask = table_size - 1;
    size_t slot = static_cast<size_t>(h) & mask;
    const int32_t* ranks = arena.p + arena.n;
    while (true) {
      int64_t id = table[slot];
      if (id == -1) {  // new distinct basket: commit the written span
        table[slot] = static_cast<int64_t>(b_off.size());
        b_off.push_back(static_cast<int64_t>(arena.n));
        b_len.push_back(static_cast<int32_t>(n));
        b_weight.push_back(1);
        b_hash.push_back(h);
        arena.n += n;
        if (b_off.size() * 10 >= table_size * 7) grow_table();
        return;
      }
      if (b_hash[id] == h && b_len[id] == static_cast<int32_t>(n) &&
          std::memcmp(arena.p + b_off[id], ranks,
                      n * sizeof(int32_t)) == 0) {
        ++b_weight[id];  // duplicate: cursor untouched (rollback)
        return;
      }
      slot = (slot + 1) & mask;
    }
  }

  // Insert one sorted, deduplicated rank list (n >= 2) with its hash
  // (RankCollector.finish computes it during the collection walk — the
  // hash function lives THERE; all inserts must use it).  False on OOM.
  bool insert(const int32_t* ranks, size_t n, uint64_t h) {
    const size_t mask = table_size - 1;
    size_t slot = static_cast<size_t>(h) & mask;
    while (true) {
      int64_t id = table[slot];
      if (id == -1) {  // new distinct basket
        table[slot] = static_cast<int64_t>(b_off.size());
        b_off.push_back(static_cast<int64_t>(arena.n));
        b_len.push_back(static_cast<int32_t>(n));
        b_weight.push_back(1);
        b_hash.push_back(h);
        if (!arena.append(ranks, n)) return false;
        // Load factor <= 0.7 keeps linear probes short.
        if (b_off.size() * 10 >= table_size * 7) grow_table();
        return true;
      }
      if (b_hash[id] == h && b_len[id] == static_cast<int32_t>(n) &&
          std::memcmp(arena.p + b_off[id], ranks,
                      n * sizeof(int32_t)) == 0) {
        ++b_weight[id];
        return true;
      }
      slot = (slot + 1) & mask;
    }
  }
};

// Per-line sorted-unique rank collection.  Small-F fast path: an F-bit
// set makes dedup free and a ctz walk emits sorted ranks in O(F/64 + n)
// instead of sort+unique's O(n log n); F is minSupport-bounded
// (hundreds on the benchmark corpora), so the per-line clear is a few
// words.  Ranks arrive as rank+1 (0 = not frequent, ignored).
struct RankCollector {
  std::vector<int32_t> scratch;
  std::vector<uint64_t> bits;
  size_t n_words = 0;
  bool use_bitset = false;

  explicit RankCollector(int32_t f) {
    n_words = (static_cast<size_t>(f) + 63) / 64;
    use_bitset = f > 0 && f <= 4096;
    if (use_bitset) bits.assign(n_words, 0);
  }
  inline void add(int32_t r_plus_1) {
    if (!r_plus_1) return;
    if (use_bitset) {
      uint32_t rr = static_cast<uint32_t>(r_plus_1 - 1);
      bits[rr >> 6] |= 1ull << (rr & 63);
    } else {
      scratch.push_back(r_plus_1 - 1);
    }
  }
  // Returns the sorted unique ranks for the current line (and clears
  // the bitset for the next one).  ``hash`` is the deduper's basket
  // hash: on the bitset fast path it folds into the ctz walk itself
  // (the ranks are register-hot there, saving the deduper a second
  // pass over every basket); the sort path (F > 4096) hashes in its
  // own pass after sort+unique.
  uint64_t hash = 0;
  static inline uint64_t mix_rank(uint64_t h, int32_t r) {
    h ^= static_cast<uint32_t>(r);
    h *= 0x9E3779B97F4A7C15ull;
    h ^= h >> 29;
    return h;
  }
  inline const std::vector<int32_t>& finish() {
    uint64_t h = 0x243F6A8885A308D3ull;
    if (use_bitset) {
      scratch.clear();
      for (size_t wi = 0; wi < n_words; ++wi) {
        uint64_t w = bits[wi];
        if (!w) continue;
        bits[wi] = 0;
        do {
          const int32_t r = static_cast<int32_t>(
              (wi << 6) + static_cast<size_t>(__builtin_ctzll(w)));
          scratch.push_back(r);
          h = mix_rank(h, r);
          w &= w - 1;
        } while (w);
      }
    } else {
      std::sort(scratch.begin(), scratch.end());
      scratch.erase(std::unique(scratch.begin(), scratch.end()),
                    scratch.end());
      for (int32_t r : scratch) h = mix_rank(h, r);
    }
    hash = h ^ scratch.size();
    return scratch;
  }
  inline void reset_list() {
    if (!use_bitset) scratch.clear();
  }
};

// Fused bitset-walk + dedup insert: emits the line's sorted ranks
// straight into the deduper's arena at the cursor (the arena IS the
// output CSR), so the scratch intermediate and the insert-time memcpy —
// a second pass over every basket's ranks, ~1 GB of cumulative traffic
// at webdocs scale — disappear; the basket hash folds into the same
// walk (same constants as RankCollector::finish).  Caller must have
// reserved arena capacity for all remaining tokens (the replay loops
// do); bitset path only.
inline void walk_insert_bitset(RankCollector& rc, BasketDeduper& dd) {
  int32_t* dst = dd.arena.p + dd.arena.n;
  uint64_t h = 0x243F6A8885A308D3ull;
  size_t n = 0;
  for (size_t wi = 0; wi < rc.n_words; ++wi) {
    uint64_t w = rc.bits[wi];
    if (!w) continue;
    rc.bits[wi] = 0;
    do {
      const int32_t r = static_cast<int32_t>(
          (wi << 6) + static_cast<size_t>(__builtin_ctzll(w)));
      dst[n++] = r;
      h = RankCollector::mix_rank(h, r);
      w &= w - 1;
    } while (w);
  }
  if (n <= 1) return;  // size<=1 baskets are dropped (reference C4)
  dd.commit_at_cursor(n, h ^ n);
}

}  // namespace

extern "C" {

struct FaResult {
  int64_t n_raw;      // raw transaction (line) count
  int64_t min_count;  // ceil(min_support * n_raw)
  int32_t n_items;    // F
  // Frequent item tokens in rank order, '\n'-joined (no trailing newline).
  char* items_buf;
  int64_t items_buf_len;
  int64_t* item_counts;  // [F] occurrence counts by rank
  int64_t n_baskets;     // T'
  int64_t* basket_offsets;  // [T'+1] CSR offsets into basket_items
  int32_t* basket_items;    // flattened sorted ranks
  int32_t* weights;         // [T'] multiplicities
};

void fa_free_result(FaResult* res);

}  // extern "C"

namespace {

// Marshal a BasketDeduper into an FaResult (zero-copy arena handoff —
// on success the arena pointer belongs to the result).  Returns false on
// OOM, leaving the arena owned by the deduper for the caller to free.
bool marshal_baskets(BasketDeduper& dd, FaResult* res) {
  const int64_t t = static_cast<int64_t>(dd.b_off.size());
  const int64_t total_items = static_cast<int64_t>(dd.arena.n);
  res->n_baskets = t;
  res->basket_offsets =
      static_cast<int64_t*>(std::malloc(sizeof(int64_t) * (t + 1)));
  res->basket_items = total_items
      ? dd.arena.p
      : static_cast<int32_t*>(std::malloc(sizeof(int32_t)));
  res->weights =
      static_cast<int32_t*>(std::malloc(sizeof(int32_t) * (t ? t : 1)));
  if (!res->basket_offsets || !res->basket_items || !res->weights) {
    if (res->basket_items == dd.arena.p) res->basket_items = nullptr;
    return false;
  }
  for (int64_t i = 0; i < t; ++i) {
    res->basket_offsets[i] = dd.b_off[i];
    res->weights[i] = dd.b_weight[i];
  }
  res->basket_offsets[t] = total_items;
  if (total_items) dd.arena.p = nullptr;  // ownership transferred
  else dd.arena.free_buf();
  return true;
}

}  // namespace


namespace {

// ---- shared pass-1 capture + rank assignment ------------------------
// ONE copy for both whole-buffer entry points (fa_preprocess_buffer and
// fa_preprocess_buffer_blocks); the sharded fa_count_buffer /
// fa_compress_with_ranks pair keeps its own split-phase contract.
//
// Pass 1: dense array for canonical small-integer tokens (the
// overwhelmingly common case), string hash map for everything else
// (calloc pages lazily, so untouched id ranges cost no physical
// memory).  Every token is also recorded once in parsed form
// (``tok_ids``, line-major with ``tok_offsets`` line boundaries): a
// dense id >= 0, or ``-(side_index+1)`` for non-dense tokens.  Pass 2
// then never touches the raw bytes again — on a 1 GB file a second
// tokenize+parse scan was half the preprocessing cost; the parsed form
// replays at memory bandwidth.

struct FreqItem {
  std::string_view tok;
  int64_t count;
  bool numeric;
  BigInt value;
};


#ifdef FA_HAVE_AVX512
// True when EVERY byte of the buffer is a decimal digit or one of the six
// Java \s whitespace chars — the shape of every integer-id transaction
// file (the reference's own datasets are exactly this).  The vectorized
// pass-1 scan below only handles that alphabet; anything else (letters,
// signs, control bytes that Java trims but does not split on) takes the
// scalar path with its full edge-case semantics.  One read of the buffer
// at memory bandwidth (~100 ms/GB) buys a ~2x faster tokenize pass.
inline bool pass1_fast_supported(std::string_view buf) {
  if (std::getenv("FA_NO_SIMD")) return false;
  const char* p = buf.data();
  size_t size = buf.size();
  const __m512i zero_ch = _mm512_set1_epi8('0');
  const __m512i nine = _mm512_set1_epi8(9);
  const __m512i tab = _mm512_set1_epi8(9);  // '\t'
  const __m512i four = _mm512_set1_epi8(4);
  const __m512i space = _mm512_set1_epi8(' ');
  uint64_t bad = 0;
  for (size_t off = 0; off < size; off += 64) {
    size_t rem = size - off;
    __mmask64 lm = rem >= 64 ? ~0ULL : ((1ULL << rem) - 1);
    __m512i v = _mm512_maskz_loadu_epi8(lm, p + off);
    uint64_t digit =
        _mm512_cmple_epu8_mask(_mm512_sub_epi8(v, zero_ch), nine);
    uint64_t ws =
        _mm512_cmpeq_epi8_mask(v, space) |
        _mm512_cmple_epu8_mask(_mm512_sub_epi8(v, tab), four);
    bad |= lm & ~(digit | ws);
    if (bad) return false;
  }
  return true;
}
#endif  // FA_HAVE_AVX512

// One pass-1 scan unit: a line-aligned byte range captured independently
// so pass 1 parallelizes across cores (a single-core scan of the webdocs
// corpus was a large share of a whole mine's wall).  Each segment
// owns its token capture and its LOCAL side-token table; the global
// merge (counts, ranks) happens once after the scan threads join, and a
// tiny per-segment ``side_rank`` remap resolves local side indexes to
// global ranks — the same merge argument as the multi-host sharded
// ingest's count tables.
struct Pass1Segment {
  int64_t n_raw = 0;
  I32Buf tok_ids;                    // dense id >= 0, or -(side_index+1)
  std::vector<int64_t> tok_offsets;  // [n_raw+1] line boundaries (local)
  std::vector<std::string_view> side_toks;   // local side index -> token
  std::unordered_map<std::string_view, std::pair<int64_t, int32_t>> counts;
  int64_t* dense_counts = nullptr;   // [kDenseCap] occurrence counts
  int64_t max_dense_id = -1;
  std::vector<int32_t> side_rank;    // rank+1 by LOCAL side index

  ~Pass1Segment() {
    std::free(dense_counts);
    tok_ids.free_buf();  // I32Buf is manually managed (ownership moves)
  }
};

struct Pass1Capture {
  int64_t n_raw = 0;
  int64_t min_count = 0;
  int32_t f = 0;
  std::deque<Pass1Segment> segs;     // 1 segment unless n_threads > 1
  std::vector<FreqItem> freq;        // rank order
  int32_t* dense_rank = nullptr;     // rank+1 by dense id (may be null)
  // Backing storage freq's string_views may point into:
  std::unordered_map<std::string_view, std::pair<int64_t, int32_t>> counts;
  std::deque<std::string> dense_tok_arena;

  ~Pass1Capture() { std::free(dense_rank); }

  inline int32_t rank_plus_1(const Pass1Segment& seg, int32_t id) const {
    return id >= 0 ? dense_rank[id] : seg.side_rank[-id - 1];
  }

  // Scan ONE line-aligned range into ``seg``.  False on allocation
  // failure.  Thread-safe across distinct segments (no shared state).
  static bool scan_segment(std::string_view buf, Pass1Segment& seg) {
    int64_t* dense_counts =
        static_cast<int64_t*>(std::calloc(kDenseCap, sizeof(int64_t)));
    auto& counts = seg.counts;
    counts.reserve(1 << 16);
    auto& side_toks = seg.side_toks;
    auto& tok_ids = seg.tok_ids;
    auto& tok_offsets = seg.tok_offsets;
    int64_t& n_raw = seg.n_raw;
    tok_ids.reserve(buf.size() / 4 + 16);
    tok_offsets.reserve(buf.size() / 64 + 16);
    // Count a non-dense token and return its encoded id (-(index+1));
    // the two scan paths append it with their own write discipline.
    auto side_id = [&](std::string_view tok) -> int32_t {
      auto [it, inserted] = counts.try_emplace(
          tok, 0, static_cast<int32_t>(side_toks.size()));
      if (inserted) side_toks.push_back(tok);
      ++it->second.first;
      return -(it->second.second + 1);
    };
    auto side_token = [&](std::string_view tok) {
      tok_ids.push_back(side_id(tok));
    };
    int64_t max_dense_id = -1;
    bool fast = false;
#ifdef FA_HAVE_AVX512
    // Vectorized scan for digits+whitespace buffers: 64-byte blocks are
    // classified into digit/newline masks; tokens are maximal digit
    // runs iterated via trailing-zero counts (a token is a contiguous
    // byte span of the buffer, so runs crossing block boundaries carry
    // only a (start, length) pair and parse at emit time).  Line
    // semantics are identical to for_each_trimmed_line on this
    // alphabet: trim == whitespace-strip, and a line with no digits
    // yields the single empty token (Java split("") -> [""]).
    if (dense_counts && pass1_fast_supported(buf)) {
      fast = true;
      const char* base = buf.data();
      size_t size = buf.size();
      size_t line_start = 0;
      bool line_open = false;
      bool line_had_token = false;
      // Unchecked writes through a raw cursor: push_back's per-element
      // size check + bump was ~30% of the whole scan (0.5 s over 226M
      // webdocs tokens).  Capacity is re-guaranteed once per 64-byte
      // BLOCK (bounded appends per block: <= 33 token emits + <= 64
      // newline empty-tokens), and the buffer's logical size is set
      // once at the end.
      int32_t* tok_raw = tok_ids.p;
      size_t tn = 0;
      auto open_line = [&] {
        if (!line_open) {
          ++n_raw;
          tok_offsets.push_back(static_cast<int64_t>(tn));
          line_open = true;
          line_had_token = false;
        }
      };
      auto close_line = [&] {
        open_line();  // whitespace-only lines still count
        if (!line_had_token) {
          tok_raw[tn++] = side_id(std::string_view(""));
        }
        line_open = false;
      };
      const char* buf_end = base + size;
      auto emit_run = [&](const char* s, size_t n) {
        open_line();
        line_had_token = true;
        if (n <= 7 && !(n > 1 && s[0] == '0')) {  // canonical decimal
          int64_t v;
          if (buf_end - s >= 8) {  // full 8-byte load stays in bounds
            // SWAR parse (simdjson-style): low byte is the most
            // significant digit; shifting the masked load left pads
            // with leading zero digits, so one multiply tree replaces
            // the n-step serial multiply-add chain (the chain's ~4
            // cycles per digit dominated the per-token cost).
            uint64_t raw;
            std::memcpy(&raw, s, 8);
            raw &= 0x0F0F0F0F0F0F0F0FULL;
            raw <<= (8 - n) * 8;
            raw = (raw * 2561) >> 8;
            raw = (raw & 0x00FF00FF00FF00FFULL) * 6553601 >> 16;
            v = static_cast<int64_t>(
                (raw & 0x0000FFFF0000FFFFULL) * 42949672960001ULL >> 32);
          } else {  // within 8 bytes of the buffer end: no overread
            v = 0;
            for (size_t i = 0; i < n; ++i) {
              v = v * 10 + static_cast<unsigned char>(s[i] - '0');
            }
          }
          ++dense_counts[v];
          if (v > max_dense_id) max_dense_id = v;
          tok_raw[tn++] = static_cast<int32_t>(v);
        } else {  // >7 digits or leading zero: non-dense token
          tok_raw[tn++] = side_id(std::string_view(s, n));
        }
      };
      const __m512i zero_ch = _mm512_set1_epi8('0');
      const __m512i nine = _mm512_set1_epi8(9);
      const __m512i newline = _mm512_set1_epi8('\n');
      const char* run_start = nullptr;  // digit run spanning blocks
      size_t run_len = 0;
      for (size_t off = 0; off < size; off += 64) {
        if (tn + 160 > tok_ids.cap) {  // per-block append bound
          if (!tok_ids.reserve(std::max(tok_ids.cap * 2, tn + 1024))) {
            throw std::bad_alloc();  // like the scalar path's push_back
          }
          tok_raw = tok_ids.p;
        }
        size_t rem = size - off;
        __mmask64 lm = rem >= 64 ? ~0ULL : ((1ULL << rem) - 1);
        __m512i v = _mm512_maskz_loadu_epi8(lm, base + off);
        uint64_t d =
            _mm512_cmple_epu8_mask(_mm512_sub_epi8(v, zero_ch), nine) & lm;
        uint64_t nl = _mm512_cmpeq_epi8_mask(v, newline) & lm;
        if (run_len) {  // run carried in from the previous block
          if (d == ~0ULL) {  // whole block digits: keep carrying
            run_len += 64;
            continue;
          }
          size_t ext = static_cast<size_t>(_tzcnt_u64(~d));
          run_len += ext;
          emit_run(run_start, run_len);
          run_len = 0;
          if (ext) d &= ~((1ULL << ext) - 1);
        }
        uint64_t starts = d & ~(d << 1);
        while (starts | nl) {
          unsigned s_pos =
              starts ? static_cast<unsigned>(_tzcnt_u64(starts)) : 64;
          unsigned n_pos =
              nl ? static_cast<unsigned>(_tzcnt_u64(nl)) : 64;
          if (n_pos < s_pos) {
            close_line();
            line_start = off + n_pos + 1;
            nl &= nl - 1;
          } else {
            uint64_t rest = d >> s_pos;
            size_t len = rest == ~0ULL
                             ? 64
                             : static_cast<size_t>(_tzcnt_u64(~rest));
            if (s_pos + len >= 64) {  // run reaches the block edge
              run_start = base + off + s_pos;
              run_len = 64 - s_pos;
            } else {
              emit_run(base + off + s_pos, len);
            }
            starts &= starts - 1;
          }
        }
      }
      if (run_len) emit_run(run_start, run_len);
      if (line_start < size) close_line();  // final line without '\n'
      tok_ids.n = tn;  // commit the cursor as the logical size
    }
#endif  // FA_HAVE_AVX512
    if (!fast) {
      for_each_trimmed_line(buf, [&](std::string_view line) {
        ++n_raw;
        tok_offsets.push_back(static_cast<int64_t>(tok_ids.size()));
        if (line.empty()) {
          side_token(std::string_view(""));  // Java split("") -> [""]
          return;
        }
        for_each_token(line, [&](std::string_view tok, int64_t dense_id) {
          if (dense_id >= 0 && dense_counts) {
            ++dense_counts[dense_id];
            if (dense_id > max_dense_id) max_dense_id = dense_id;
            tok_ids.push_back(static_cast<int32_t>(dense_id));
          } else {
            side_token(tok);
          }
        });
      });
    }
    tok_offsets.push_back(static_cast<int64_t>(tok_ids.size()));
    seg.dense_counts = dense_counts;
    seg.max_dense_id = max_dense_id;
    return true;
  }

  // False on allocation failure.  ``n_threads > 1`` scans line-aligned
  // segments on std::threads (pass 1 parallelized); 1 is the exact
  // legacy single-segment scan.
  bool run(std::string_view buf, double min_support, PhaseTimer& timer,
           int32_t n_threads = 1) {
    // Line-aligned segment boundaries (same rule as the Python side's
    // split_buffer_ranges: nominal cut advanced past the next '\n';
    // the straddling line belongs to the earlier segment).
    std::vector<size_t> cuts{0};
    const size_t size = buf.size();
    const int32_t n_segs = n_threads > 1 ? n_threads : 1;
    for (int32_t i = 1; i < n_segs; ++i) {
      size_t b = (size * static_cast<size_t>(i)) / n_segs;
      size_t prev = cuts.back();
      if (b <= prev) {
        cuts.push_back(prev);
        continue;
      }
      if (buf[b - 1] == '\n') {
        cuts.push_back(b);
      } else {
        size_t j = buf.find('\n', b);
        cuts.push_back(j == std::string_view::npos ? size : j + 1);
      }
    }
    cuts.push_back(size);
    for (size_t i = 0; i + 1 < cuts.size(); ++i) segs.emplace_back();
    std::atomic<bool> ok{true};
    if (segs.size() == 1) {
      ok = scan_segment(buf, segs[0]);
    } else {
      std::vector<std::thread> threads;
      threads.reserve(segs.size());
      for (size_t s = 0; s < segs.size(); ++s) {
        threads.emplace_back([&, s] {
          if (!scan_segment(buf.substr(cuts[s], cuts[s + 1] - cuts[s]),
                            segs[s])) {
            ok = false;
          }
        });
      }
      for (auto& th : threads) th.join();
    }
    if (!ok) return false;
    timer.mark("pass1_tokenize_count");

    // ---- merge (tiny next to the scans: count tables only) ----------
    n_raw = 0;
    int64_t max_dense_id = -1;
    for (auto& seg : segs) {
      n_raw += seg.n_raw;
      if (seg.max_dense_id > max_dense_id) max_dense_id = seg.max_dense_id;
    }
    // Dense counts merge into segment 0's array (untouched id ranges
    // cost no physical pages; the loop runs only to the global max id).
    // Multi-segment requires the dense arrays uniformly present: a
    // token dense-counted in one segment but side-counted in another
    // (one calloc failed) would split its count across two tables and
    // silently mis-threshold — treat that as the OOM it is.
    if (segs.size() > 1) {
      for (auto& seg : segs) {
        if (!seg.dense_counts) return false;
      }
    }
    int64_t* dense_counts = segs[0].dense_counts;
    for (size_t s = 1; s < segs.size(); ++s) {
      int64_t* dc = segs[s].dense_counts;
      for (int64_t id = 0; id <= segs[s].max_dense_id; ++id) {
        dense_counts[id] += dc[id];
      }
    }
    if (segs.size() == 1) {
      counts = std::move(segs[0].counts);
    } else {
      for (auto& seg : segs) {
        for (const auto& [tok, cs] : seg.counts) {
          auto [it, inserted] = counts.try_emplace(tok, cs.first, -1);
          if (!inserted) it->second.first += cs.first;
        }
      }
    }
    min_count = static_cast<int64_t>(
        std::ceil(min_support * static_cast<double>(n_raw)));

    for (int64_t id = 0; id <= max_dense_id; ++id) {
      int64_t c = dense_counts ? dense_counts[id] : 0;
      if (c > 0 && c >= min_count) {  // c > 0: only tokens actually seen
        dense_tok_arena.push_back(std::to_string(id));
        std::string_view tok = dense_tok_arena.back();
        BigInt v;
        parse_int(tok, &v);
        freq.push_back({tok, c, true, v});
      }
    }
    for (const auto& [tok, cs] : counts) {
      if (cs.first >= min_count) {
        BigInt v;
        bool num = parse_int(tok, &v);
        freq.push_back({tok, cs.first, num, v});
      }
    }
    std::sort(freq.begin(), freq.end(),
              [](const FreqItem& a, const FreqItem& b) {
                if (a.count != b.count) return a.count > b.count;
                if (a.numeric != b.numeric) return a.numeric;
                if (a.numeric) {
                  if (bigint_less(a.value, b.value)) return true;
                  if (bigint_less(b.value, a.value)) return false;
                }
                return a.tok < b.tok;
              });
    f = static_cast<int32_t>(freq.size());
    // Rank tables (rank+1; 0 = not frequent) keyed the same way pass 1
    // recorded the tokens: dense id -> GLOBAL dense_rank, local side
    // index -> per-segment side_rank remap.  Pass 2's per-token lookup
    // is one array read either way.
    if (dense_counts && max_dense_id >= 0) {
      dense_rank = static_cast<int32_t*>(
          std::calloc(max_dense_id + 1, sizeof(int32_t)));
      if (!dense_rank) return false;  // dense tok_ids unresolvable
    }
    std::unordered_map<std::string_view, int32_t> side_of;  // tok->rank+1
    for (int32_t r = 0; r < f; ++r) {
      int64_t id = freq[r].numeric ? fast_id(freq[r].tok) : -1;
      // A canonical-decimal token lands in dense_rank only if SOME
      // segment dense-tracked it; with per-segment dense alloc failures
      // it may live in the side tables instead — route it there too.
      bool in_dense = dense_rank && id >= 0 && id <= max_dense_id &&
                      dense_counts && dense_counts[id] > 0;
      if (in_dense) {
        dense_rank[id] = r + 1;
      }
      if (!in_dense || segs.size() > 1) {
        // Multi-segment: a token can be dense in one segment and
        // side-tracked in another (alloc failure); publish both.
        side_of[freq[r].tok] = r + 1;
      }
    }
    for (auto& seg : segs) {
      seg.side_rank.assign(seg.side_toks.size(), 0);
      for (size_t i = 0; i < seg.side_toks.size(); ++i) {
        auto it = side_of.find(seg.side_toks[i]);
        if (it != side_of.end()) seg.side_rank[i] = it->second;
      }
      std::free(seg.dense_counts);
      seg.dense_counts = nullptr;
    }
    dense_counts = nullptr;  // freed via segs[0]
    timer.mark("rank_assign");
    return true;
  }
};

// Collect one line's ranks from the captured token ids into the
// collector.  AVX-512 fast path for the dominant shape (all-dense ids,
// bitset-sized F): 16 rank lookups ride one gather — the serial
// load -> rank lookup -> bit set chain was ~14 cycles/token and pass-2
// replay is one rank lookup per captured token (226M on webdocs).
// Frequent lanes compress into a register-packed buffer and set bits
// scalar (f <= 4096 keeps the words in L1).  Any negative (side-table)
// lane falls back to the scalar path for that group.
inline void collect_line_ranks(
    const Pass1Capture& p1, const Pass1Segment& seg, RankCollector& rc,
    int64_t ti, int64_t ti_end) {
#ifdef FA_HAVE_AVX512
  const int32_t* ids = seg.tok_ids.p;
  const int32_t* dr = p1.dense_rank;
  if (dr && rc.use_bitset) {
    uint64_t* bits = rc.bits.data();
    for (; ti + 16 <= ti_end; ti += 16) {
      __m512i v = _mm512_loadu_si512(
          reinterpret_cast<const void*>(ids + ti));
      __mmask16 neg =
          _mm512_cmplt_epi32_mask(v, _mm512_setzero_si512());
      if (neg) {  // rare: side-table tokens in this group
        for (int i = 0; i < 16; ++i) {
          rc.add(p1.rank_plus_1(seg, ids[ti + i]));
        }
        continue;
      }
      __m512i ranks = _mm512_i32gather_epi32(v, dr, 4);  // rank+1
      __mmask16 freq =
          _mm512_cmpgt_epi32_mask(ranks, _mm512_setzero_si512());
      alignas(64) int32_t rbuf[16];
      _mm512_store_si512(
          rbuf,
          _mm512_maskz_compress_epi32(
              freq, _mm512_sub_epi32(ranks, _mm512_set1_epi32(1))));
      const int n = __builtin_popcount(freq);
      for (int i = 0; i < n; ++i) {
        const uint32_t rr = static_cast<uint32_t>(rbuf[i]);
        bits[rr >> 6] |= 1ull << (rr & 63);
      }
    }
  }
#endif  // FA_HAVE_AVX512
  for (; ti < ti_end; ++ti) rc.add(p1.rank_plus_1(seg, seg.tok_ids[ti]));
}

// Marshal the global tables (items in rank order + counts) into res.
// False on allocation failure.
bool marshal_tables(const Pass1Capture& p1, FaResult* res) {
  res->n_raw = p1.n_raw;
  res->min_count = p1.min_count;
  res->n_items = p1.f;
  int64_t items_len = 0;
  for (const auto& item : p1.freq) items_len += item.tok.size() + 1;
  res->items_buf =
      static_cast<char*>(std::malloc(items_len ? items_len : 1));
  res->items_buf_len = items_len ? items_len - 1 : 0;  // drop trailing \n
  res->item_counts =
      static_cast<int64_t*>(std::malloc(sizeof(int64_t) * (p1.f ? p1.f : 1)));
  if (!res->items_buf || !res->item_counts) return false;
  char* p = res->items_buf;
  for (const auto& item : p1.freq) {
    std::memcpy(p, item.tok.data(), item.tok.size());
    p += item.tok.size();
    *p++ = '\n';
  }
  for (int32_t r = 0; r < p1.f; ++r) res->item_counts[r] = p1.freq[r].count;
  return true;
}

}  // namespace

extern "C" {

// data/len: raw file bytes.  Not nul-terminated.  Returns a heap-allocated
// result (free with fa_free_result) or nullptr on allocation failure.
FaResult* fa_preprocess_buffer(const char* data, int64_t len,
                               double min_support) {
  PhaseTimer timer;
  std::string_view buf(data, static_cast<size_t>(len));

  Pass1Capture p1;
  if (!p1.run(buf, min_support, timer)) return nullptr;
  const Pass1Segment& seg = p1.segs[0];  // single-segment entry point

  // ---- pass 2: basket dedup with multiplicity --------------------------
  // Replays the parsed tokens captured in pass 1 (tok_ids) — no second
  // scan of the raw bytes.
  BasketDeduper dd;
  // Upper bound: one rank per captured token.  Reserving up front keeps
  // realloc from copying the growing arena (~1.2 GB of cumulative copy
  // at Webdocs scale); pages are committed lazily, so over-reservation
  // costs virtual space only.
  if (!dd.arena.reserve(seg.tok_ids.size() + 1)) return nullptr;
  RankCollector rc(p1.f);
  if (rc.use_bitset) {
    // Fused walk+insert straight into the arena (no scratch pass).
    for (int64_t li = 0; li < p1.n_raw; ++li) {
      collect_line_ranks(
          p1, seg, rc, seg.tok_offsets[li], seg.tok_offsets[li + 1]);
      walk_insert_bitset(rc, dd);
    }
  } else {
    for (int64_t li = 0; li < p1.n_raw; ++li) {
      rc.reset_list();
      collect_line_ranks(
          p1, seg, rc, seg.tok_offsets[li], seg.tok_offsets[li + 1]);
      const auto& ranks = rc.finish();
      if (ranks.size() <= 1) continue;
      if (!dd.insert(ranks.data(), ranks.size(), rc.hash)) {
        dd.arena.free_buf();
        return nullptr;
      }
    }
  }
  timer.mark("pass2_dedup");

  // ---- marshal ---------------------------------------------------------
  auto* res = static_cast<FaResult*>(std::calloc(1, sizeof(FaResult)));
  if (!res) {
    dd.arena.free_buf();
    return nullptr;
  }
  bool ok = marshal_tables(p1, res) && marshal_baskets(dd, res);
  if (!ok) {
    // fa_free_result tolerates the partially-filled struct
    // (free(nullptr) is a no-op); the arena is still the deduper's.
    dd.arena.free_buf();
    fa_free_result(res);
    return nullptr;
  }
  timer.mark("marshal");
  return res;
}

// Fill a caller-allocated bit-packed vertical bitmap (MSB-first within
// each byte, matching numpy packbits / ops/fused.py pack_bitmap) straight
// from the CSR baskets: out[row, col>>3] |= 0x80 >> (col&7).  Replaces
// the host-side dense [T, F] int8 intermediate + packbits pass (~0.5 GB
// of traffic at Webdocs scale).  ``out`` must be zeroed, with
// ``row_stride`` bytes per row (= padded F / 8).
void fa_fill_packed_bitmap(const int64_t* offsets, const int32_t* items,
                           int64_t n_baskets, int64_t row_stride,
                           uint8_t* out) {
  for (int64_t i = 0; i < n_baskets; ++i) {
    uint8_t* row = out + i * row_stride;
    for (int64_t j = offsets[i]; j < offsets[i + 1]; ++j) {
      int32_t col = items[j];
      row[col >> 3] |= static_cast<uint8_t>(0x80u >> (col & 7));
    }
  }
}

// ---- sharded-ingest split phases -------------------------------------

struct FaCounts {
  int64_t n_lines;
  int64_t n_tokens;    // distinct tokens seen in this buffer
  char* tokens_buf;    // '\n'-joined distinct tokens (arbitrary order)
  int64_t tokens_buf_len;
  int64_t* counts;     // [n_tokens] occurrence counts
};

void fa_free_counts(FaCounts* res) {
  if (!res) return;
  std::free(res->tokens_buf);
  std::free(res->counts);
  std::free(res);
}

FaCounts* fa_count_buffer(const char* data, int64_t len) {
  std::string_view buf(data, static_cast<size_t>(len));
  int64_t* dense_counts =
      static_cast<int64_t*>(std::calloc(kDenseCap, sizeof(int64_t)));
  std::unordered_map<std::string_view, int64_t> side;
  side.reserve(1 << 14);
  int64_t max_dense_id = -1;
  int64_t n_lines = 0;
  for_each_trimmed_line(buf, [&](std::string_view line) {
    ++n_lines;
    if (line.empty()) {
      ++side[std::string_view("")];  // Java split("") -> [""]
      return;
    }
    for_each_token(line, [&](std::string_view tok, int64_t dense_id) {
      if (dense_id >= 0 && dense_counts) {
        ++dense_counts[dense_id];
        if (dense_id > max_dense_id) max_dense_id = dense_id;
      } else {
        ++side[tok];
      }
    });
  });

  auto* res = static_cast<FaCounts*>(std::calloc(1, sizeof(FaCounts)));
  if (!res) {
    std::free(dense_counts);
    return nullptr;
  }
  res->n_lines = n_lines;
  std::vector<std::pair<std::string, int64_t>> items;
  for (int64_t id = 0; id <= max_dense_id; ++id) {
    if (dense_counts[id] > 0) {
      items.emplace_back(std::to_string(id), dense_counts[id]);
    }
  }
  for (const auto& [tok, c] : side) {
    items.emplace_back(std::string(tok), c);
  }
  std::free(dense_counts);
  res->n_tokens = static_cast<int64_t>(items.size());
  int64_t buf_len = 0;
  for (const auto& [tok, c] : items) buf_len += tok.size() + 1;
  res->tokens_buf = static_cast<char*>(std::malloc(buf_len ? buf_len : 1));
  res->counts = static_cast<int64_t*>(
      std::malloc(sizeof(int64_t) * (items.empty() ? 1 : items.size())));
  if (!res->tokens_buf || !res->counts) {
    fa_free_counts(res);
    return nullptr;
  }
  res->tokens_buf_len = buf_len ? buf_len - 1 : 0;  // drop trailing '\n'
  char* w = res->tokens_buf;
  for (size_t i = 0; i < items.size(); ++i) {
    std::memcpy(w, items[i].first.data(), items[i].first.size());
    w += items[i].first.size();
    *w++ = '\n';
    res->counts[i] = items[i].second;
  }
  return res;
}

// ranks_buf: '\n'-joined item tokens in GLOBAL rank order (f of them).
// Returns an FaResult whose baskets/weights cover only this buffer's
// lines; item_counts is zeroed and items_buf empty (the caller owns the
// global tables).
FaResult* fa_compress_with_ranks(const char* data, int64_t len,
                                 const char* ranks_buf, int64_t ranks_len,
                                 int32_t f) {
  std::string_view buf(data, static_cast<size_t>(len));
  // Rank lookup tables keyed like the tokenizer classifies: canonical
  // small decimals through a dense array, everything else via the map.
  int64_t max_dense_id = -1;
  std::vector<std::pair<std::string_view, int32_t>> side_entries;
  std::vector<std::pair<int64_t, int32_t>> dense_entries;
  {
    std::string_view rb(ranks_buf, static_cast<size_t>(ranks_len));
    size_t pos = 0;
    int32_t r = 0;
    while (r < f) {
      size_t nl = rb.find('\n', pos);
      size_t end = (nl == std::string_view::npos) ? rb.size() : nl;
      std::string_view tok = rb.substr(pos, end - pos);
      int64_t id = fast_id(tok);
      if (id >= 0) {
        dense_entries.emplace_back(id, r + 1);
        if (id > max_dense_id) max_dense_id = id;
      } else {
        side_entries.emplace_back(tok, r + 1);
      }
      ++r;
      if (nl == std::string_view::npos) break;
      pos = nl + 1;
    }
    if (r != f) return nullptr;  // malformed rank table
  }
  int32_t* dense_rank = nullptr;
  if (max_dense_id >= 0) {
    dense_rank = static_cast<int32_t*>(
        std::calloc(max_dense_id + 1, sizeof(int32_t)));
    if (!dense_rank) return nullptr;
    for (const auto& [id, r] : dense_entries) dense_rank[id] = r;
  }
  std::unordered_map<std::string_view, int32_t> side_rank;
  side_rank.reserve(side_entries.size() * 2 + 8);
  for (const auto& [tok, r] : side_entries) side_rank[tok] = r;

  // One pass over this buffer (re-tokenizes; there is no pass-1 capture
  // here — the extra scan is per-shard and parallel across processes).
  BasketDeduper dd;
  RankCollector rc(f);
  int64_t n_lines = 0;
  bool oom = false;
  // On dedup OOM the remaining lines are still split/trimmed (the
  // callback just skips their work) — a known, accepted cost: OOM here
  // is terminal for the shard anyway, and a bool-returning line walker
  // isn't worth complicating the shared helper for.
  for_each_trimmed_line(buf, [&](std::string_view line) {
    if (oom) return;
    ++n_lines;
    rc.reset_list();
    if (line.empty()) {
      auto it = side_rank.find(std::string_view(""));
      if (it != side_rank.end()) rc.add(it->second);
    } else {
      for_each_token(line, [&](std::string_view tok, int64_t dense_id) {
        if (dense_id >= 0) {
          if (dense_rank && dense_id <= max_dense_id) {
            rc.add(dense_rank[dense_id]);
          }
        } else {
          auto it = side_rank.find(tok);
          if (it != side_rank.end()) rc.add(it->second);
        }
      });
    }
    const auto& ranks = rc.finish();
    if (ranks.size() <= 1) return;
    if (!dd.insert(ranks.data(), ranks.size(), rc.hash)) oom = true;
  });
  if (oom) {
    dd.arena.free_buf();
    std::free(dense_rank);
    return nullptr;
  }

  auto* res = static_cast<FaResult*>(std::calloc(1, sizeof(FaResult)));
  if (!res) {
    dd.arena.free_buf();
    std::free(dense_rank);
    return nullptr;
  }
  res->n_raw = n_lines;
  res->min_count = 0;
  res->n_items = f;
  res->items_buf = static_cast<char*>(std::malloc(1));
  res->items_buf_len = 0;
  res->item_counts =
      static_cast<int64_t*>(std::calloc(f ? f : 1, sizeof(int64_t)));
  bool ok =
      res->items_buf && res->item_counts && marshal_baskets(dd, res);
  if (!ok) {
    dd.arena.free_buf();
    std::free(dense_rank);
    fa_free_result(res);
    return nullptr;
  }
  std::free(dense_rank);
  return res;
}

void fa_free_result(FaResult* res) {
  if (!res) return;
  std::free(res->items_buf);
  std::free(res->item_counts);
  std::free(res->basket_offsets);
  std::free(res->basket_items);
  std::free(res->weights);
  std::free(res);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Apriori candidate generation (reference C7, FastApriori.scala:167-193):
// prefix join + subset prune over a lex-sorted [M, s] level matrix.  The
// numpy implementation (models/candidates.py) spends ~99% of its time in
// the prune's per-subset searchsorted passes (it cannot early-exit per
// candidate); this native version prunes each candidate with early exit
// and a per-(group, drop-position) narrowed binary-search range, making
// host candidate generation a non-factor next to device counting.

namespace {

// Rows [lo, hi) of `level` whose first `plen` ints equal `key` (binary
// search twice over the lex-sorted matrix).
struct RowRange {
  int64_t lo, hi;
};

inline int cmp_prefix(const int32_t* a, const int32_t* key, int32_t plen) {
  for (int32_t d = 0; d < plen; ++d) {
    if (a[d] != key[d]) return a[d] < key[d] ? -1 : 1;
  }
  return 0;
}

RowRange prefix_range(const int32_t* level, int64_t m, int32_t s,
                      const int32_t* key, int32_t plen) {
  int64_t lo = 0, hi = m;
  while (lo < hi) {  // first row with prefix >= key
    int64_t mid = (lo + hi) >> 1;
    if (cmp_prefix(level + mid * s, key, plen) < 0) lo = mid + 1;
    else hi = mid;
  }
  int64_t lo2 = lo, hi2 = m;
  while (lo2 < hi2) {  // first row with prefix > key
    int64_t mid = (lo2 + hi2) >> 1;
    if (cmp_prefix(level + mid * s, key, plen) <= 0) lo2 = mid + 1;
    else hi2 = mid;
  }
  return {lo, lo2};
}

// Is (a_last, y) present as the last two elements of a row inside
// [r.lo, r.hi) (rows there share the first s-2 ints already)?
inline bool tail_exists(const int32_t* level, int32_t s, RowRange r,
                        int32_t a_last, int32_t y) {
  int64_t lo = r.lo, hi = r.hi;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    const int32_t* row = level + mid * s + (s - 2);
    bool lt = row[0] != a_last ? row[0] < a_last : row[1] < y;
    if (lt) lo = mid + 1;
    else hi = mid;
  }
  if (lo >= r.hi) return false;
  const int32_t* row = level + lo * s + (s - 2);
  return row[0] == a_last && row[1] == y;
}

}  // namespace

extern "C" {

struct FaCandidates {
  int64_t n;
  int64_t* x_idx;  // [n] prefix row index into the level matrix
  int32_t* y;      // [n] extension rank
};

void fa_free_candidates(FaCandidates* c);

// level: lex-sorted int32 [m, s] row-major.  Returns survivors of the
// prefix join + Apriori subset prune in global (x_idx, y) order, or
// nullptr on allocation failure.  Free with fa_free_candidates.
FaCandidates* fa_gen_candidates(const int32_t* level, int64_t m, int32_t s) {
  auto* res = static_cast<FaCandidates*>(std::malloc(sizeof(FaCandidates)));
  if (!res) return nullptr;
  res->n = 0;
  res->x_idx = nullptr;
  res->y = nullptr;
  if (m < 2 || s < 1) {
    res->x_idx = static_cast<int64_t*>(std::malloc(sizeof(int64_t)));
    res->y = static_cast<int32_t*>(std::malloc(sizeof(int32_t)));
    if (!res->x_idx || !res->y) {
      fa_free_candidates(res);
      return nullptr;
    }
    return res;
  }
  std::vector<int64_t> xs;
  std::vector<int32_t> ys;
  std::vector<int32_t> sub(s);
  // Per-(group, drop-position) narrowed range: rows matching the
  // candidate subset's first s-2 ints (= group prefix minus one element,
  // plus x's last for the deepest position).  Reused across the group's
  // pairs, so each pair's membership test is a short tail search.
  std::vector<RowRange> ranges(s > 1 ? s - 1 : 1);

  auto row = [&](int64_t i) { return level + i * s; };
  int64_t g0 = 0;
  for (int64_t i = 1; i <= m; ++i) {
    bool boundary =
        (i == m) ||
        (s > 1 &&
         std::memcmp(row(i), row(i - 1), sizeof(int32_t) * (s - 1)) != 0);
    if (s == 1) boundary = (i == m);  // single group when s == 1
    if (!boundary) continue;
    const int64_t gn = i - g0;
    if (gn >= 2) {
      const int32_t* shared = row(g0);  // first s-1 ints shared
      if (s == 1) {
        // Level 1 never reaches here in the mining engine (level 2 is
        // the pair matmul) but keep the join semantics total: no prune
        // (candidates have no (s-1)-subsets beyond the joined rows).
        for (int64_t a = g0; a < i; ++a)
          for (int64_t b = a + 1; b < i; ++b) {
            xs.push_back(a);
            ys.push_back(row(b)[0]);
          }
      } else {
        // Precompute, per drop position d in the shared prefix, the row
        // range matching (shared minus position d) as a first-(s-2)
        // prefix.  The candidate subset for (a, b, d) is that prefix +
        // (x_last, y): membership is a tail search in the range.
        for (int32_t d = 0; d + 1 < s; ++d) {
          int32_t w = 0;
          for (int32_t e = 0; e + 1 < s; ++e)
            if (e != d) sub[w++] = shared[e];
          ranges[d] = prefix_range(level, m, s, sub.data(), s - 2);
        }
        for (int64_t a = g0; a < i; ++a) {
          const int32_t a_last = row(a)[s - 1];
          for (int64_t b = a + 1; b < i; ++b) {
            const int32_t yv = row(b)[s - 1];
            bool ok = true;
            for (int32_t d = 0; d + 1 < s; ++d) {
              if (!tail_exists(level, s, ranges[d], a_last, yv)) {
                ok = false;
                break;
              }
            }
            if (ok) {
              xs.push_back(a);
              ys.push_back(yv);
            }
          }
        }
      }
    }
    g0 = i;
  }
  const int64_t n = static_cast<int64_t>(xs.size());
  res->n = n;
  res->x_idx = static_cast<int64_t*>(std::malloc(sizeof(int64_t) * (n ? n : 1)));
  res->y = static_cast<int32_t*>(std::malloc(sizeof(int32_t) * (n ? n : 1)));
  if (!res->x_idx || !res->y) {
    fa_free_candidates(res);
    return nullptr;
  }
  if (n) {
    std::memcpy(res->x_idx, xs.data(), sizeof(int64_t) * n);
    std::memcpy(res->y, ys.data(), sizeof(int32_t) * n);
  }
  return res;
}

void fa_free_candidates(FaCandidates* c) {
  if (!c) return;
  std::free(c->x_idx);
  std::free(c->y);
  std::free(c);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Pipelined single-host ingest, capture-replay form: the whole
// fa_preprocess_buffer pipeline (pass-1 capture, rank assignment, pass-2
// id replay — never re-tokenizing the raw bytes) but with pass 2 split
// into ``n_blocks`` contiguous line ranges, each handed to the caller
// through ``cb`` AS SOON as it is deduplicated — the Python side starts
// that block's device upload while this function compresses the next
// block.  Per-block dedup only (cross-block duplicate baskets stay
// separate weighted rows; weighted counts are identical — the multi-host
// sharded-ingest correctness argument).  The returned FaResult carries
// the global tables (n_raw, min_count, items, counts) with ZERO baskets;
// the caller assembles the basket CSR from the callback copies.

extern "C" {

typedef void (*FaBlockCb)(void* ctx, int32_t f, int64_t n_baskets,
                          const int64_t* offsets, const int32_t* items,
                          const int32_t* weights);

// Pass-1-complete callback (fa_preprocess_buffer_blocks2): fires once
// after the global tables exist and BEFORE any block replays — the
// caller's chance to pick a layout (e.g. the vertical-engine density
// probe, models/apriori.py) while keeping the capture pipeline's
// tokenize-once property.  ``counts`` are the [f] occurrence counts in
// rank order, valid only for the duration of the callback.
typedef void (*FaPass1Cb)(void* ctx, int64_t n_raw, int64_t min_count,
                          int32_t f, const int64_t* counts);

}  // extern "C"

static FaResult* preprocess_buffer_blocks_impl(
    const char* data, int64_t len, double min_support, int32_t n_blocks,
    int32_t n_threads, FaPass1Cb pass1_cb, FaBlockCb cb, void* cb_ctx) {
  PhaseTimer timer;
  std::string_view buf(data, static_cast<size_t>(len));

  Pass1Capture p1;
  // Pass 1 itself parallelizes across n_threads line-aligned segments
  // (scan_segment) — the OVERLAPPED two-pass ingest: on a multi-core
  // host the tokenize+count scan and the per-block replay below each
  // run at ~n_threads the single-core rate, and replay workers overlap
  // the main thread's callback/packing/upload work.
  if (!p1.run(buf, min_support, timer, n_threads)) return nullptr;
  if (pass1_cb) {
    std::vector<int64_t> cnts(static_cast<size_t>(p1.f));
    for (int32_t r = 0; r < p1.f; ++r) {
      cnts[static_cast<size_t>(r)] = p1.freq[static_cast<size_t>(r)].count;
    }
    pass1_cb(cb_ctx, p1.n_raw, p1.min_count, p1.f,
             cnts.empty() ? nullptr : cnts.data());
  }

  // ---- pass 2: per-block replay + dedup + callback --------------------
  // Blocks split by TOKEN count (not line count) so work per block is
  // even regardless of line-length skew, distributed across pass-1
  // segments by token share (a block never spans segments — the
  // capture buffers are per-segment).  With n_threads > 1 the blocks
  // replay on std::threads (each block has its own deduper; cross-block
  // duplicates stay separate weighted rows) while the MAIN thread
  // invokes cb strictly in block order — the caller sees the same
  // deterministic stream either way.
  if (n_blocks < 1) n_blocks = 1;
  if (n_threads < 1) n_threads = 1;
  struct Range {
    const Pass1Segment* seg;
    int64_t lo, hi;
  };
  std::vector<Range> ranges;
  {
    int64_t total_tok = 0;
    for (const auto& seg : p1.segs) {
      total_tok += static_cast<int64_t>(seg.tok_ids.size());
    }
    for (const auto& seg : p1.segs) {
      if (seg.n_raw == 0) continue;
      const int64_t n_tok = static_cast<int64_t>(seg.tok_ids.size());
      int32_t blocks_s =
          total_tok > 0
              ? static_cast<int32_t>(
                    (static_cast<int64_t>(n_blocks) * n_tok + total_tok - 1) /
                    total_tok)
              : 1;
      if (blocks_s < 1) blocks_s = 1;
      int64_t line_lo = 0;
      for (int32_t b = 0; b < blocks_s && line_lo < seg.n_raw; ++b) {
        const int64_t tok_target = (n_tok * (b + 1)) / blocks_s;
        int64_t line_hi = seg.n_raw;
        if (b != blocks_s - 1) {
          line_hi = std::upper_bound(seg.tok_offsets.begin() + line_lo,
                                     seg.tok_offsets.begin() + seg.n_raw,
                                     tok_target - 1)
                    - seg.tok_offsets.begin();
          if (line_hi <= line_lo) line_hi = line_lo + 1;
          if (line_hi > seg.n_raw) line_hi = seg.n_raw;
        }
        ranges.push_back({&seg, line_lo, line_hi});
        line_lo = line_hi;
      }
    }
  }

  // Replay one segment's lines [lo, hi) into a fresh deduper.  False
  // on OOM.
  auto replay_block = [&p1](const Range& r, BasketDeduper& dd) {
    const Pass1Segment& seg = *r.seg;
    if (!dd.arena.reserve(
            static_cast<size_t>(seg.tok_offsets[r.hi] -
                                seg.tok_offsets[r.lo]) +
            1)) {
      return false;
    }
    RankCollector rc(p1.f);
    if (rc.use_bitset) {
      // Fused walk+insert straight into the arena (no scratch pass);
      // capacity for every remaining token is reserved above.
      for (int64_t li = r.lo; li < r.hi; ++li) {
        collect_line_ranks(
            p1, seg, rc, seg.tok_offsets[li], seg.tok_offsets[li + 1]);
        walk_insert_bitset(rc, dd);
      }
      return true;
    }
    for (int64_t li = r.lo; li < r.hi; ++li) {
      rc.reset_list();
      collect_line_ranks(
          p1, seg, rc, seg.tok_offsets[li], seg.tok_offsets[li + 1]);
      const auto& ranks = rc.finish();
      if (ranks.size() <= 1) continue;
      if (!dd.insert(ranks.data(), ranks.size(), rc.hash)) return false;
    }
    return true;
  };

  bool oom = false;
  std::vector<int64_t> offs;
  auto emit = [&](BasketDeduper& dd) {  // main thread only
    const int64_t t = static_cast<int64_t>(dd.b_off.size());
    if (t > 0) {
      offs.resize(t + 1);
      for (int64_t i = 0; i < t; ++i) offs[i] = dd.b_off[i];
      offs[t] = static_cast<int64_t>(dd.arena.n);
      cb(cb_ctx, p1.f, t, offs.data(), dd.arena.p, dd.b_weight.data());
    }
    dd.arena.free_buf();
  };

  if (n_threads == 1 || ranges.size() <= 1) {
    double replay_s = 0.0, cb_s = 0.0;  // FA_NATIVE_TIMING sub-phases
    for (const Range& r : ranges) {
      BasketDeduper dd;
      auto t_replay0 = std::chrono::steady_clock::now();
      bool ok = replay_block(r, dd);
      replay_s += std::chrono::duration<double>(
                      std::chrono::steady_clock::now() - t_replay0)
                      .count();
      if (!ok) {
        dd.arena.free_buf();
        oom = true;
        break;
      }
      auto t_cb0 = std::chrono::steady_clock::now();
      emit(dd);
      cb_s += std::chrono::duration<double>(
                  std::chrono::steady_clock::now() - t_cb0)
                  .count();
    }
    if (timer.on) {
      std::fprintf(stderr, "fa_native[pass2.replay_dedup]: %.3f s\n",
                   replay_s);
      std::fprintf(stderr, "fa_native[pass2.callback]: %.3f s\n", cb_s);
    }
  } else {
    struct BlockOut {
      BasketDeduper dd;
      bool ok = false;
      bool ready = false;
    };
    std::vector<BlockOut> outs(ranges.size());
    std::mutex mu;
    std::condition_variable cv;
    std::atomic<size_t> next{0};
    auto worker = [&]() {
      while (true) {
        const size_t b = next.fetch_add(1);
        if (b >= ranges.size()) break;
        BlockOut& o = outs[b];
        o.ok = replay_block(ranges[b], o.dd);
        {
          std::lock_guard<std::mutex> lk(mu);
          o.ready = true;
        }
        cv.notify_all();
      }
    };
    const size_t nt = std::min<size_t>(n_threads, ranges.size());
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (size_t i = 0; i < nt; ++i) threads.emplace_back(worker);
    for (size_t b = 0; b < outs.size(); ++b) {
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return outs[b].ready; });
      }
      if (!outs[b].ok) {
        outs[b].dd.arena.free_buf();
        oom = true;
        continue;  // drain remaining blocks' buffers below
      }
      if (!oom) emit(outs[b].dd);
      else outs[b].dd.arena.free_buf();
    }
    for (auto& th : threads) th.join();
  }
  timer.mark("pass2_dedup_blocks");
  if (oom) return nullptr;

  // ---- marshal (tables only; baskets live in the callback copies) -----
  auto* res = static_cast<FaResult*>(std::calloc(1, sizeof(FaResult)));
  if (!res) return nullptr;
  res->n_baskets = 0;
  res->basket_offsets =
      static_cast<int64_t*>(std::calloc(1, sizeof(int64_t)));
  res->basket_items = static_cast<int32_t*>(std::malloc(sizeof(int32_t)));
  res->weights = static_cast<int32_t*>(std::malloc(sizeof(int32_t)));
  if (!marshal_tables(p1, res) || !res->basket_offsets ||
      !res->basket_items || !res->weights) {
    fa_free_result(res);
    return nullptr;
  }
  timer.mark("marshal");
  return res;
}

extern "C" {

FaResult* fa_preprocess_buffer_blocks(const char* data, int64_t len,
                                      double min_support, int32_t n_blocks,
                                      int32_t n_threads, FaBlockCb cb,
                                      void* cb_ctx) {
  return preprocess_buffer_blocks_impl(data, len, min_support, n_blocks,
                                       n_threads, nullptr, cb, cb_ctx);
}

FaResult* fa_preprocess_buffer_blocks2(const char* data, int64_t len,
                                       double min_support, int32_t n_blocks,
                                       int32_t n_threads, FaPass1Cb pass1_cb,
                                       FaBlockCb cb, void* cb_ctx) {
  return preprocess_buffer_blocks_impl(data, len, min_support, n_blocks,
                                       n_threads, pass1_cb, cb, cb_ctx);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Output layout (io/writer.py): rows of token ids printed as text lines and
// laid out whole in one buffer, so an artifact is hashed and written as one
// chunk.  freqItemset / freqItems (Utils.scala:29-41, 51-63): each row's
// tokens in descending rank order (the row reversed), one space apart, an
// optional "[count]" suffix, the lines sorted; recommends (Utils.scala:48):
// one token a row, in the order given.

namespace {

struct LineRef {
  int64_t off;  // start in the unsorted buffer
  int64_t len;  // bytes, without the newline
};

// Buckets of at most this many lines are sorted by comparison.
constexpr int64_t kSmallBucket = 64;

// A line's bucket at `depth`: 0 when it ends there (a proper prefix of
// every other line in its bucket, so it sorts first), else 1 + its byte.
inline int line_bucket(const char* base, const LineRef& r, int64_t depth) {
  return r.len > depth
             ? 1 + static_cast<uint8_t>(base[r.off + depth])
             : 0;
}

// Counts the lines of each bucket at `depth` into start[0..257] as
// bucket offsets (bucket c is [start[c], start[c + 1])).  Returns the
// bucket that holds all n lines, or -1.
int bucket_starts(const LineRef* refs, int64_t n, const char* base,
                  int64_t depth, int64_t* start) {
  int64_t cnt[257] = {0};
  for (int64_t i = 0; i < n; ++i) ++cnt[line_bucket(base, refs[i], depth)];
  int64_t pos = 0;
  int whole = -1;
  for (int c = 0; c < 257; ++c) {
    if (cnt[c] == n) whole = c;
    start[c] = pos;
    pos += cnt[c];
  }
  start[257] = pos;
  return whole;
}

// Moves the lines into their buckets (start from bucket_starts).
void scatter_lines(LineRef* refs, LineRef* tmp, int64_t n, const char* base,
                   int64_t depth, const int64_t* start) {
  int64_t fill[257];
  std::memcpy(fill, start, sizeof fill);
  for (int64_t i = 0; i < n; ++i)
    tmp[fill[line_bucket(base, refs[i], depth)]++] = refs[i];
  std::memcpy(refs, tmp, sizeof(LineRef) * static_cast<size_t>(n));
}

// Sorts n lines that agree on their first `depth` bytes into byte order,
// a proper prefix first: Python's order of the decoded str lines, since
// UTF-8 keeps code-point order.  A most-significant-byte radix sort: one
// byte a pass over each bucket, the small buckets by comparison; tmp
// holds n refs.  The buckets still to sort are kept on a heap stack, so
// lines with long shared prefixes cannot exhaust a thread's stack.
void sort_line_refs(LineRef* refs, LineRef* tmp, int64_t n, const char* base,
                    int64_t depth) {
  struct Part {
    int64_t lo, n, depth;
  };
  std::vector<Part> todo{{0, n, depth}};
  while (!todo.empty()) {
    const Part part = todo.back();
    todo.pop_back();
    LineRef* r = refs + part.lo;
    const int64_t d = part.depth;
    if (part.n <= kSmallBucket) {
      std::sort(r, r + part.n, [base, d](const LineRef& x, const LineRef& y) {
        const int64_t rx = x.len - d, ry = y.len - d;
        const int c = std::memcmp(base + x.off + d, base + y.off + d,
                                  static_cast<size_t>(rx < ry ? rx : ry));
        return c != 0 ? c < 0 : rx < ry;
      });
      continue;
    }
    int64_t start[258];
    const int whole = bucket_starts(r, part.n, base, d, start);
    if (whole == 0) continue;  // every line ends here: all equal
    if (whole > 0) {
      todo.push_back({part.lo, part.n, d + 1});
      continue;
    }
    scatter_lines(r, tmp + part.lo, part.n, base, d, start);
    for (int c = 1; c < 257; ++c)
      if (start[c + 1] - start[c] > 1)
        todo.push_back({part.lo + start[c], start[c + 1] - start[c], d + 1});
  }
}

// sort_line_refs from depth 0, the buckets of the first byte sorted on up
// to 8 threads, the largest first (the host is idle while a job writes).
void sort_lines(LineRef* refs, LineRef* tmp, int64_t n, const char* base) {
  int64_t start[258];
  if (n <= kSmallBucket || bucket_starts(refs, n, base, 0, start) >= 0) {
    sort_line_refs(refs, tmp, n, base, 0);
    return;
  }
  scatter_lines(refs, tmp, n, base, 0, start);
  std::vector<int> todo;
  for (int c = 1; c < 257; ++c)
    if (start[c + 1] - start[c] > 1) todo.push_back(c);
  std::sort(todo.begin(), todo.end(), [&start](int x, int y) {
    return start[x + 1] - start[x] > start[y + 1] - start[y];
  });
  std::atomic<size_t> next{0};
  std::atomic<bool> out_of_memory{false};
  auto work = [&]() {
    try {
      for (size_t w; (w = next++) < todo.size();) {
        const int c = todo[w];
        sort_line_refs(refs + start[c], tmp + start[c],
                       start[c + 1] - start[c], base, 1);
      }
    } catch (const std::bad_alloc&) {
      out_of_memory = true;
    }
  };
  const unsigned hw = std::thread::hardware_concurrency();
  const size_t n_threads =
      std::min<size_t>({hw ? hw : 1u, 8u, todo.size()});
  std::vector<std::thread> threads;
  try {
    for (size_t t = 1; t < n_threads; ++t) threads.emplace_back(work);
  } catch (const std::system_error&) {
    // Fewer threads than asked: the calling thread takes the rest.
  }
  work();
  for (std::thread& t : threads) t.join();
  if (out_of_memory) throw std::bad_alloc();
}

inline uint64_t magnitude(int64_t v) {
  return v < 0 ? 0 - static_cast<uint64_t>(v) : static_cast<uint64_t>(v);
}

// Characters of str(v).
inline int64_t decimal_len(int64_t v) {
  uint64_t u = magnitude(v);
  int64_t n = v < 0 ? 2 : 1;
  while (u >= 10) {
    u /= 10;
    ++n;
  }
  return n;
}

inline char* put_decimal(char* p, int64_t v) {
  uint64_t u = magnitude(v);
  if (v < 0) *p++ = '-';
  char buf[20];
  int n = 0;
  do {
    buf[n++] = static_cast<char>('0' + u % 10);
    u /= 10;
  } while (u);
  while (n) *p++ = buf[--n];
  return p;
}

}  // namespace

extern "C" {

// pool/pool_len: n_tokens tokens, '\n'-separated (no trailing newline).
// mats[l]: int32 [rows[l], ks[l]] row-major token ids, each row printed
// from its last column to its first, one space apart.  counts: null, or
// one int64 [rows[l]] per level, printed as "[count]" after the row.
// sorted_lines != 0 sorts the lines (sort_lines); else they follow the rows.
// Every line ends with '\n'.  out == nullptr asks for the size.  Returns
// the bytes the lines take (written to out when given), -1 for malformed
// input (a token id out of range, a pool with another number of tokens,
// ks[l] < 1, rows[l] < 0), -2 when out_len is too small, -3 when memory
// runs out.
int64_t fa_format_lines(const char* pool, int64_t pool_len, int32_t n_tokens,
                        int32_t n_levels, const int32_t* const* mats,
                        const int64_t* rows, const int32_t* ks,
                        const int64_t* const* counts, int32_t sorted_lines,
                        char* out, int64_t out_len) {
  try {
    if (n_tokens < 0 || n_levels < 0 || pool_len < 0) return -1;
    std::vector<int64_t> tok_start(n_tokens), tok_len(n_tokens);
    {
      int64_t start = 0;
      for (int32_t t = 0; t < n_tokens; ++t) {
        const void* nl =
            t + 1 < n_tokens
                ? std::memchr(pool + start, '\n',
                              static_cast<size_t>(pool_len - start))
                : nullptr;
        if (t + 1 < n_tokens && !nl) return -1;
        const int64_t end =
            nl ? static_cast<const char*>(nl) - pool : pool_len;
        tok_start[t] = start;
        tok_len[t] = end - start;
        start = end + 1;
      }
      const int64_t used = n_tokens ? start - 1 : 0;
      if (used != pool_len ||
          (n_tokens &&
           std::memchr(pool + tok_start[n_tokens - 1], '\n',
                       static_cast<size_t>(tok_len[n_tokens - 1]))))
        return -1;
    }
    int64_t total = 0, n_lines = 0;
    for (int32_t l = 0; l < n_levels; ++l) {
      const int64_t r = rows[l], k = ks[l];
      if (k < 1 || r < 0) return -1;
      const int32_t* m = mats[l];
      for (int64_t i = 0; i < r * k; ++i) {
        const int32_t id = m[i];
        if (id < 0 || id >= n_tokens) return -1;
        total += tok_len[id];
      }
      total += r * k;  // k - 1 spaces and the newline a row
      if (counts)
        for (int64_t i = 0; i < r; ++i) total += 2 + decimal_len(counts[l][i]);
      n_lines += r;
    }
    if (!out) return total;
    if (out_len < total) return -2;

    auto emit = [&](char* p, int32_t l, int64_t i) {
      const int32_t k = ks[l];
      const int32_t* row = mats[l] + i * k;
      for (int32_t j = k - 1; j >= 0; --j) {
        const int32_t id = row[j];
        std::memcpy(p, pool + tok_start[id], static_cast<size_t>(tok_len[id]));
        p += tok_len[id];
        if (j) *p++ = ' ';
      }
      if (counts) {
        *p++ = '[';
        p = put_decimal(p, counts[l][i]);
        *p++ = ']';
      }
      return p;
    };

    if (!sorted_lines) {
      char* p = out;
      for (int32_t l = 0; l < n_levels; ++l)
        for (int64_t i = 0; i < rows[l]; ++i) {
          p = emit(p, l, i);
          *p++ = '\n';
        }
      return total;
    }
    // The lines without their newlines, in row order, then sorted by
    // reference and copied out.
    std::unique_ptr<char[]> text(new char[total - n_lines + 1]);
    std::vector<LineRef> refs(static_cast<size_t>(n_lines));
    std::vector<LineRef> tmp(static_cast<size_t>(n_lines));
    char* p = text.get();
    int64_t x = 0;
    for (int32_t l = 0; l < n_levels; ++l)
      for (int64_t i = 0; i < rows[l]; ++i) {
        char* start = p;
        p = emit(p, l, i);
        refs[x++] = {start - text.get(), p - start};
      }
    const char* base = text.get();
    sort_lines(refs.data(), tmp.data(), n_lines, base);
    char* q = out;
    for (const LineRef& ref : refs) {
      std::memcpy(q, base + ref.off, static_cast<size_t>(ref.len));
      q += ref.len;
      *q++ = '\n';
    }
    return total;
  } catch (const std::bad_alloc&) {
    return -3;
  }
}

}  // extern "C"
