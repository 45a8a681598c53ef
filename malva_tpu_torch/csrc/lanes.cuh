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

constexpr int kMaxWords64 = (kMaxLen + 31) / 32;

// 2-bit code of a base (A=0 C=1 G=2 T=3, either case), or 4 for any
// other byte.  Lowercase counts as its uppercase, as after seq.upper.
MALVA_HD uint32_t base_code(uint8_t b) {
  switch (b | 0x20) {
    case 'a': return 0;
    case 'c': return 1;
    case 'g': return 2;
    case 't': return 3;
    default: return 4;
  }
}

// Canonical 2-bit form of one ref_k window of raw bytes, for the sample
// counter: false when a byte is not A/C/G/T (KMC skips such k-mers), else
// `words` holds the lexicographic min of the forward codes and the
// reverse complement (3 - code, read backwards), base j in word j / 32
// at bit 2 * (31 - j % 32) (malva_tpu/ops/seq.py pack_2bit).  Equal to
// the strcmp/RCN canonical form on pure-ACGT windows, since code order
// is ASCII order and 3 - code is the RCN complement.
MALVA_HD bool canonical_window(const uint8_t* s, int ref_k, uint64_t* words) {
  const int w = (ref_k + 31) / 32;
  uint64_t fwd[kMaxWords64], rc[kMaxWords64];
  for (int i = 0; i < w; ++i) fwd[i] = rc[i] = 0;
  for (int j = 0; j < ref_k; ++j) {
    const uint64_t c = base_code(s[j]);
    if (c > 3) return false;
    const int r = ref_k - 1 - j;
    fwd[j >> 5] |= c << (2 * (31 - (j & 31)));
    rc[r >> 5] |= (3 - c) << (2 * (31 - (r & 31)));
  }
  bool take_fwd = true;  // a palindrome's two forms are equal
  for (int i = 0; i < w; ++i) {
    if (fwd[i] != rc[i]) {
      take_fwd = fwd[i] < rc[i];
      break;
    }
  }
  for (int i = 0; i < w; ++i) words[i] = take_fwd ? fwd[i] : rc[i];
  return true;
}

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
