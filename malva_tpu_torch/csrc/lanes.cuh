// Per-lane work of the two kernels, header-only and __host__ __device__,
// so the same arithmetic compiles for sm_90a and for a host build.
//
// Packed contexts: 16 bases per uint32 word, base 0 in the top 2 bits,
// A=0 C=1 G=2 T=3 (ops/packed.py).  Byte strings follow the reference's
// strcmp canonicalization under the RCN complement (xxh3.cuh: rcn).
#pragma once

#include "xxh3.cuh"

namespace malva {

constexpr int kMaxLen = 240;                 // longest hashed string
constexpr int kMaxWords = (kMaxLen + 15) / 16;
constexpr int kSlots = 4;                    // exact-map bucket slots
constexpr uint32_t kRankBits = 28;           // rank | mini-filter << 28
constexpr uint32_t kRankMask = (1u << kRankBits) - 1;

MALVA_HD uint32_t code_at(const uint32_t* w, int j) {
  return (w[j >> 4] >> (2 * (15 - (j & 15)))) & 3u;
}

MALVA_HD uint8_t ascii_of(uint32_t c) {
  return (uint8_t)(65 + 2 * c + (c == 2 ? 2 : 0) + (c == 3 ? 13 : 0));
}

// ASCII form of the first n bases of a packed sequence.
MALVA_HD void decode_ascii(const uint32_t* w, int n, uint8_t* out) {
  for (int j = 0; j < n; ++j) out[j] = ascii_of(code_at(w, j));
}

// Canonical centered k-mer of a packed context: its ASCII form into
// `buf` and, when `can` is not null, its packed words.  The reverse
// complement in 2-bit space is code ^ 3 read backwards; the forward form
// wins only when strictly smaller (ties keep the reverse complement,
// which is then equal).
MALVA_HD void canonical_center(const uint32_t* w, int k, int ref_k, uint8_t* buf,
                               uint32_t* can) {
  const int off = (ref_k - k) / 2;
  bool fwd = false;
  for (int j = 0; j < k; ++j) {
    uint32_t f = code_at(w, off + j);
    uint32_t r = 3u - code_at(w, off + k - 1 - j);
    if (f != r) {
      fwd = f < r;
      break;
    }
  }
  if (can)
    for (int i = 0; i < (k + 15) / 16; ++i) can[i] = 0;
  for (int j = 0; j < k; ++j) {
    uint32_t c = fwd ? code_at(w, off + j) : 3u - code_at(w, off + k - 1 - j);
    buf[j] = ascii_of(c);
    if (can) can[j >> 4] |= c << (2 * (15 - (j & 15)));
  }
}

// Canonical form of n raw bytes (any byte values): min of the bytes and
// their RCN reverse complement by strcmp (host_kernels.cpp canonical_row).
MALVA_HD void canonical_bytes(const uint8_t* s, int n, uint8_t* out) {
  for (int j = 0; j < n; ++j) out[j] = rcn(s[n - 1 - j]);
  for (int j = 0; j < n; ++j) {
    if (s[j] < out[j]) {
      for (int i = 0; i < n; ++i) out[i] = s[i];
      return;
    }
    if (s[j] > out[j]) return;
  }
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
// 2 * (15 - j % 16) (the pack_2bit layout, malva_tpu_torch/ops/seq.py);
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

MALVA_HD bool bit_is_set(const uint32_t* words, uint64_t idx) {
  return (words[idx >> 5] >> (idx & 31)) & 1u;
}

// Flat exact-map slot of a packed key, or -1: bucket b1 then b2, low slot
// first (kmap_table.py probe_bucket_table: first match wins).
MALVA_HD int64_t probe_buckets(const uint32_t* keys, uint64_t n_buckets, int w_k,
                               const uint32_t* can, uint64_t h) {
  const uint32_t hi = (uint32_t)(h >> 32), lo = (uint32_t)h;
  const uint32_t mask = (uint32_t)(n_buckets - 1);
  const uint32_t b[2] = {(lo ^ hi) & mask,
                         ((lo * 0x9E3779B1u) ^ (hi * 0x85EBCA77u)) & mask};
  for (int t = 0; t < 2; ++t) {
    for (int s = 0; s < kSlots; ++s) {
      const uint64_t slot = (uint64_t)b[t] * kSlots + s;
      const uint32_t* key = keys + slot * w_k;
      bool eq = true;
      for (int j = 0; j < w_k; ++j) eq = eq && key[j] == can[j];
      if (eq) return (int64_t)slot;
    }
  }
  return -1;
}

}  // namespace malva
