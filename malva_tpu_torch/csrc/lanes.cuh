// Per-lane work of the kernels, header-only and __host__ __device__, so
// the same arithmetic compiles for sm_90a and for a host build (the g++
// tests: tests/test_torch_lanes.py, tests/test_torch_count.py).
//
// Packed contexts: 16 bases per uint32 word, base 0 in the top 2 bits,
// A=0 C=1 G=2 T=3 (ops/packed.py).  Byte strings follow the reference's
// strcmp canonicalization under the RCN complement (xxh3.cuh: rcn).
//
// Nothing here indexes an array with a run-time value: the word count N
// of a packed sequence is a template parameter, every loop over it
// unrolls, and a run-time word offset is taken by an unrolled select
// (pick).  So every array stays in registers, never in local memory.
#pragma once

#include "xxh3.cuh"

namespace malva {

constexpr int kMaxLen = 240;                 // longest hashed string
constexpr int kSlots = 4;                    // exact-map bucket slots
constexpr uint32_t kRankBits = 28;           // rank | mini-filter << 28
constexpr uint32_t kRankMask = (1u << kRankBits) - 1;

// -- packed 2-bit sequences in registers (K1, K4) ---------------------------

// a[q], or T{} for q outside 0..N-1, by an unrolled select.
template <class T, int N>
MALVA_HD T pick(const T (&a)[N], int q) {
  T r{};
#pragma unroll
  for (int i = 0; i < N; ++i) r = i == q ? a[i] : r;
  return r;
}

// a[q] = v for a run-time q, by an unrolled select.
template <class T, int N>
MALVA_HD void put(T (&a)[N], int q, T v) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = i == q ? v : a[i];
}

MALVA_HD uint32_t ascii_of(uint32_t c) {
  return 65 + 2 * c + (c == 2 ? 2 : 0) + (c == 3 ? 13 : 0);
}

// ASCII of four bases whose codes fill 8 bits (the first in the top two),
// the first in byte 0.  The product spreads the four codes to bytes 0..3
// (the copies of b at bits 0, 10, 20 and 30 cannot carry into each
// other); then A C G T = 65 + 2c + 2 [c >= 2] + 11 [c == 3], a byte at a time.
MALVA_HD uint32_t ascii4(uint32_t b) {
  const uint32_t c = ((b * 0x40100401u) >> 6) & 0x03030303u;
  const uint32_t h = (c >> 1) & 0x01010101u;  // G or T
  return 0x41414141u + (c << 1) + (h << 1) + (c & h) * 11u;
}

// Reverse the order of the 16 bases of a word (bit reversal, then each
// pair's two bits swapped back).
MALVA_HD uint32_t rev_bases(uint32_t x) {
#ifdef __CUDA_ARCH__
  x = __brev(x);
#else
  x = ((x & 0x55555555u) << 1) | ((x >> 1) & 0x55555555u);
  x = ((x & 0x33333333u) << 2) | ((x >> 2) & 0x33333333u);
  x = ((x & 0x0F0F0F0Fu) << 4) | ((x >> 4) & 0x0F0F0F0Fu);
  x = ((x & 0x00FF00FFu) << 8) | ((x >> 8) & 0x00FF00FFu);
  x = (x << 16) | (x >> 16);
#endif
  return ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
}

// Shift a packed sequence left by nb bases (0 <= nb < 16 N), zero-filled:
// the word shift in log2(N) stages of constant moves, then one funnel
// shift per word.
template <int N>
MALVA_HD void shift_bases(uint32_t (&w)[N], int nb) {
  const int ws = nb >> 4;
#pragma unroll
  for (int b = 1; b < N; b <<= 1) {
    const bool on = (ws & b) != 0;
#pragma unroll
    for (int i = 0; i < N; ++i) w[i] = on ? (i + b < N ? w[i + b] : 0u) : w[i];
  }
  const uint32_t s = 2u * (nb & 15);
#pragma unroll
  for (int i = 0; i < N; ++i) w[i] = funnel_l(i + 1 < N ? w[i + 1] : 0u, w[i], s);
}

// Zero every base from n on.
template <int N>
MALVA_HD void keep_bases(uint32_t (&w)[N], int n) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int m = n - 16 * i;  // bases of word i to keep
    w[i] &= m >= 16 ? 0xFFFFFFFFu : m <= 0 ? 0u : ~(0xFFFFFFFFu >> (2 * m));
  }
}

// Canonical centred k-mer of a packed context of ref_k bases (bits past
// ref_k are ignored), as N words with zeros past base k.  The reverse
// complement of the whole context is its words in reverse order, each
// with its bases reversed and complemented (code ^ 3); the centre's
// reverse complement then starts 16 N - off - k bases into it.  The
// forward form wins only when strictly smaller (ties keep the reverse
// complement, which is then equal).
template <int N>
MALVA_HD void canonical_centre(const uint32_t (&ctx)[N], int k, int ref_k, uint32_t (&can)[N]) {
  const int off = (ref_k - k) / 2;
  uint32_t f[N], r[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    f[i] = ctx[i];
    r[i] = ~rev_bases(ctx[N - 1 - i]);
  }
  shift_bases(f, off);
  shift_bases(r, 16 * N - off - k);
  keep_bases(f, k);
  keep_bases(r, k);
  bool less = false, decided = false;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    less = decided ? less : f[i] < r[i];
    decided = decided || f[i] != r[i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) can[i] = less ? f[i] : r[i];
}

// XXH3 reader over a packed sequence held in N registers: byte o is the
// ASCII of base o.  The eight bases of an r64 come from one funnel shift
// of two words, then two ascii4; a constant offset needs no select.
template <int N>
struct PackedBases {
  static constexpr int kMaxLen = 16 * N;
  uint32_t w[N];

  MALVA_HD explicit PackedBases(const uint32_t (&src)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) w[i] = src[i];
  }
  // codes of bases o..o+15, base o in the top two bits (zeros past word N-1)
  MALVA_HD uint32_t bases16(int o) const {
    const int q = o >> 4;
    return funnel_l(pick(w, q + 1), pick(w, q), 2u * (o & 15));
  }
  MALVA_HD uint32_t r8(int o) const { return ascii_of(bases16(o) >> 30); }
  MALVA_HD uint32_t r32(int o) const { return ascii4(bases16(o) >> 24); }
  MALVA_HD uint64_t r64(int o) const {
    const uint32_t f = bases16(o);
    return ascii4(f >> 24) | (uint64_t)ascii4((f >> 16) & 0xFFu) << 32;
  }
};

// The per-lane front end of K1 and K4: the canonical centre of a
// packed context into `can`, and its XXH3.
template <int N>
MALVA_HD uint64_t centre_hash(const uint32_t (&ctx)[N], int k, int ref_k, uint32_t (&can)[N]) {
  canonical_centre(ctx, k, ref_k, can);
  return xxh3_64(PackedBases<N>(can), k);
}

// -- byte tiles (K2) ---------------------------------------------------------
//
// A tile holds bytes t[0..L) in aligned little-endian words `fwd` and its
// RCN-reversed copy in `rev`: rev byte j = rcn(t[E - 1 - j]), E = L
// rounded up to a multiple of 4, so that rev word q is rcn_reverse4 of fwd
// word E/4 - 1 - q.  The RCN reverse complement of the window t[p..p+n)
// is then the contiguous slice rev[E-p-n .. E-p).  Both buffers carry 12
// bytes past their end, which the readers may load and never use.

// XXH3 reader over bytes in aligned 32-bit words (shared memory on the
// card), from byte `start` on: word loads joined by funnel shifts.
struct WordBytes {
  static constexpr int kMaxLen = 240;
  const uint32_t* w;
  int start;

  MALVA_HD uint32_t r8(int o) const {
    const int a = start + o;
    return (w[a >> 2] >> (8 * (a & 3))) & 0xFFu;
  }
  MALVA_HD uint32_t r32(int o) const {
    const int a = start + o;
    return funnel_r(w[a >> 2], w[(a >> 2) + 1], 8u * (a & 3));
  }
  MALVA_HD uint64_t r64(int o) const {
    const int a = start + o, q = a >> 2;
    const uint32_t s = 8u * (a & 3), mid = w[q + 1];
    return funnel_r(w[q], mid, s) | (uint64_t)funnel_r(mid, w[q + 2], s) << 32;
  }
};

// The RCN complements of four bytes in reverse order (byte i of the
// result from byte 3 - i of w), by a 256-byte table of rcn.
MALVA_HD uint32_t rcn_reverse4(uint32_t w, const uint8_t* table) {
  return (uint32_t)table[w >> 24] | (uint32_t)table[(w >> 16) & 0xFFu] << 8 |
         (uint32_t)table[(w >> 8) & 0xFFu] << 16 | (uint32_t)table[w & 0xFFu] << 24;
}

// For x != y, eight bytes each, little-endian: whether x's byte is the
// smaller at the first byte where they differ.
MALVA_HD bool first_byte_less(uint64_t x, uint64_t y) {
#ifdef __CUDA_ARCH__
  const int s = (__ffsll((long long)(x ^ y)) - 1) & ~7;
#else
  const int s = __builtin_ctzll(x ^ y) & ~7;
#endif
  return ((x >> s) & 0xFFu) < ((y >> s) & 0xFFu);
}

// The canonical form of the n-byte window at byte p of a tile: the
// forward bytes, when strictly smaller byte by byte (any byte values),
// else the reverse complement.  Eight bytes are compared at a time, and
// the first that differ decide.
MALVA_HD WordBytes canonical_window(const uint32_t* fwd, const uint32_t* rev, int E, int p, int n) {
  const WordBytes f{fwd, p}, r{rev, E - p - n};
  for (int o = 0; o < n; o += 8) {
    uint64_t x = f.r64(o), y = r.r64(o);
    if (n - o < 8) {
      const uint64_t m = ~0ULL >> (64 - 8 * (n - o));
      x &= m;
      y &= m;
    }
    if (x != y) return first_byte_less(x, y) ? f : r;
  }
  return r;
}

// XXH3 of the canonical form of the n-byte window at byte p of a tile.
MALVA_HD uint64_t window_hash_at(const uint32_t* fwd, const uint32_t* rev, int E, int p, int n) {
  return xxh3_64(canonical_window(fwd, rev, E, p, n), n);
}

// -- K3: canonical keys of read windows, rolled one base at a time ----------

// 2-bit codes of four raw bytes at once (byte i of `w` gives byte i of the
// result): A/C/G/T in either case give 0/1/2/3, any other byte 4 or more
// (bit 2 set).  The code of each of the eight letters is
// ((b >> 1) ^ (b >> 2)) & 3; a byte is a base iff (b | 0x20) is the
// lowercase letter of its code.  Every per-byte sum stays below 0x100, so
// no carry crosses a byte.
MALVA_HD uint32_t base_codes4(uint32_t w) {
  const uint32_t x = w | 0x20202020u;
  const uint32_t c = ((x >> 1) ^ (x >> 2)) & 0x03030303u;
  const uint32_t h = (c >> 1) & 0x01010101u;  // code 2 or 3
  const uint32_t t = c & h;                   // code 3
  // the lowercase letter of each code: a = 0x61, c = 0x63, g = 0x67, t = 0x74
  const uint32_t e = 0x61616161u + (c << 1) + (h << 1) + t * 11u;
  const uint32_t d = x ^ e;  // 0 in each byte that is its letter
  const uint32_t zero = ~(((d & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | d | 0x7F7F7F7Fu);
  return c | ((~zero & 0x80808080u) >> 5);
}

// What the rolling step needs of ref_k.
struct RollShape {
  int ref_k;
  uint32_t ins_shift;  // bit offset of base ref_k - 1 in the last word
  uint32_t last_mask;  // the bits of the last word that lie in the window
};

MALVA_HD RollShape roll_shape(int ref_k) {
  const int tail = ref_k - 16 * ((ref_k - 1) / 16);  // bases in the last word, 1..16
  return {ref_k, 2u * (16 - tail), tail == 16 ? 0xFFFFFFFFu : ~(0xFFFFFFFFu >> (2 * tail))};
}

// The canonical 2-bit key of a window that moves one base at a time, in
// N = ceil(ref_k / 16) 32-bit words.  N is a template parameter, so every
// array index below is a constant once the loops unroll and the state
// lives in registers.  Base j of the window sits in word j / 16 at bits
// 2 * (15 - j % 16) (the pack2bit layout, malva_tpu_torch/ops/packed.py);
// the reverse complement (3 - code, read backwards) in the same layout.
// A push shifts the forward form left by one base and writes the new base
// last, shifts the reverse complement right by one base and writes its
// complement first, and counts the bases since the last byte that is not
// A/C/G/T.  O(N) work per window, where building a window afresh reads
// ref_k bytes.
template <int N>
struct RollingKey {
  static constexpr int W = (N + 1) / 2;  // 64-bit words of a key
  uint32_t fwd[2 * W], rc[2 * W];        // word N, where N is odd, stays 0
  int run;  // bases since the last byte that is not A/C/G/T

  MALVA_HD void reset() {
    for (int i = 0; i < 2 * W; ++i) fwd[i] = rc[i] = 0;
    run = 0;
  }

  // `code` is a byte of base_codes4: 0..3 for a base, 4 or more for any other byte.
  MALVA_HD void push(uint32_t code, const RollShape& s) {
    const uint32_t c = code & 3u;
#pragma unroll
    for (int i = 0; i + 1 < N; ++i) fwd[i] = (fwd[i] << 2) | (fwd[i + 1] >> 30);
    fwd[N - 1] = (fwd[N - 1] << 2) | (c << s.ins_shift);
#pragma unroll
    for (int i = N - 1; i > 0; --i) rc[i] = (rc[i] >> 2) | (rc[i - 1] << 30);
    rc[0] = (rc[0] >> 2) | ((3u - c) << 30);
    rc[N - 1] &= s.last_mask;
    run = code > 3 ? 0 : run + 1;
  }

  // Whether the window is pure A/C/G/T (either case; KMC skips the rest),
  // and its key in `out` as W 64-bit words: the lexicographic min of the
  // two forms (a palindrome's are equal), or zeros for an invalid window.
  // Code order is ASCII order and 3 - code is the RCN complement, so this
  // is the strcmp/RCN canonical form (malva_tpu_torch/ops/seq.py canonical).
  MALVA_HD bool key(const RollShape& s, uint64_t* out) const {
    const bool ok = run >= s.ref_k;
    bool less = false, decided = false;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      less = decided ? less : fwd[i] < rc[i];
      decided = decided || fwd[i] != rc[i];
    }
    const bool take_fwd = less || !decided;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const uint32_t hi = take_fwd ? fwd[2 * j] : rc[2 * j];
      const uint32_t lo = take_fwd ? fwd[2 * j + 1] : rc[2 * j + 1];
      out[j] = ok ? ((uint64_t)hi << 32) | lo : 0;
    }
    return ok;
  }
};

// -- the gathered Bloom row and the exact map (K1, K4; K5: gather.cuh) ---------

// What a lane's gathered [word, rank | mini-filter << kRankBits] row says
// about its centre hash c: `what` bit 0, its Bloom bit is set; bit 1, it
// may be in the exact map (always, unless `use_mf`: then its mini-filter
// bit, hash bits 60-61, must be set); and the index of its rank-compressed
// counter (the rank is the row's low kRankBits bits where the row carries
// a mini-filter).
struct RowTest {
  uint32_t what, cidx;
};

MALVA_HD RowTest row_test(uint32_t word, uint32_t aux, uint64_t c, uint64_t size_bits,
                          bool minifilter, bool use_mf) {
  const uint32_t bit = (uint32_t)(bloom_index(c, size_bits) & 31);
  const uint32_t set = (word >> bit) & 1u;
  const uint32_t cand = use_mf ? ((aux >> kRankBits) >> (uint32_t)((c >> 60) & 3)) & 1u : 1u;
  const uint32_t rank = minifilter ? (aux & kRankMask) : aux;
  return {set | cand << 1, rank + popc32(word & ((1u << bit) - 1u))};
}

// The two candidate buckets of a key with XXH3 h in a table of n_buckets (a
// power of two): b1 = lo ^ hi, b2 = lo * C1 ^ hi * C2, masked
// (kmap_table.py bucket_pair).
MALVA_HD void bucket_pair(uint64_t h, uint64_t n_buckets, uint32_t (&b)[2]) {
  const uint32_t hi = (uint32_t)(h >> 32), lo = (uint32_t)h;
  const uint32_t mask = (uint32_t)(n_buckets - 1);
  b[0] = (lo ^ hi) & mask;
  b[1] = ((lo * 0x9E3779B1u) ^ (hi * 0x85EBCA77u)) & mask;
}

// Flat exact-map slot of a canonical key held in N registers (w_k <= N
// words used), or -1: bucket b1 then b2, low slot first (kmap_table.py
// probe_bucket_table: first match wins).  A slot is w_k words at a
// 4 w_k-byte stride, so it has no vector alignment; a bucket's 4 w_k word
// loads are issued together, each on its own predicate, before any
// compare (K1, K4; K5's probe of its shard's range of one global table
// is gather.cuh probe_pair).
template <int N>
MALVA_HD int64_t probe_buckets(const uint32_t* keys, uint64_t n_buckets, int w_k,
                               const uint32_t (&can)[N], uint64_t h) {
  uint32_t b[2];
  bucket_pair(h, n_buckets, b);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const uint64_t lb = b[t];
    const uint32_t* bucket = keys + lb * kSlots * w_k;
    int hit = -1;
#pragma unroll
    for (int s = kSlots - 1; s >= 0; --s) {  // the lowest matching slot is taken last
      bool eq = true;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const uint32_t v = j < w_k ? bucket[s * w_k + j] : can[j];
        eq = eq & (v == can[j]);
      }
      hit = eq ? s : hit;
    }
    if (hit >= 0) return (int64_t)lb * kSlots + hit;
  }
  return -1;
}

}  // namespace malva
