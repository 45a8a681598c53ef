// XXH3_64bits (seed 0, default secret) for one short input, header-only,
// __host__ __device__.  Lengths 0..240: the genotyper hashes k-mers and
// contexts of at most 240 bytes (k = 35, ref_k = 43 take the 17..128
// path).  Host spec: csrc/host_kernels.cpp:472 xxh3_one; the 128-bit
// product of mix16 uses __umul64hi on the device.
//
// One body serves every kernel: xxh3_64 is a template over a *reader*, an
// object whose r64(o), r32(o) and r8(o) return the little-endian 64-bit,
// 32-bit and 8-bit value at byte offset o of the input, and whose kMaxLen
// bounds the lengths it is asked for (the paths past it compile away).
// The readers:
//   * BytePtr: a byte pointer (the host spec, and the g++ tests);
//   * WordBytes (lanes.cuh): bytes held in aligned 32-bit words, a tile in
//     shared memory on the card, read with word loads and funnel shifts;
//   * PackedBases<N> (lanes.cuh): 2-bit codes in N registers, each byte
//     the ASCII of one base.
// The secret is 24 constexpr 64-bit words; every secret offset below is a
// template argument, so each secret word folds into an immediate.
//
// Also holds the other per-lane helpers the kernels share: the RCN
// complement, the Bloom index (hash % size_bits), the uint32 popcount and
// the funnel shifts.
#pragma once

#include <stdint.h>

#include <utility>

#ifdef __CUDACC__
#define MALVA_HD __host__ __device__ __forceinline__
#define MALVA_HDC __host__ __device__ constexpr
#else
#define MALVA_HD inline
#define MALVA_HDC constexpr
#endif

namespace malva {

constexpr uint64_t PRIME64_1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t PRIME64_2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t PRIME64_3 = 0x165667B19E3779F9ULL;
constexpr uint64_t PRIME_MX1 = 0x165667919E3779F9ULL;
constexpr uint64_t PRIME_MX2 = 0x9FB21C651E98DF25ULL;

// The 192-byte default secret as little-endian 64-bit words.
constexpr uint64_t kSecret[24] = {
    0xbe4ba423396cfeb8ULL, 0x1cad21f72c81017cULL, 0xdb979083e96dd4deULL,
    0x1f67b3b7a4a44072ULL, 0x78e5c0cc4ee679cbULL, 0x2172ffcc7dd05a82ULL,
    0x8e2443f7744608b8ULL, 0x4c263a81e69035e0ULL, 0xcb00c391bb52283cULL,
    0xa32e531b8b65d088ULL, 0x4ef90da297486471ULL, 0xd8acdea946ef1938ULL,
    0x3f349ce33f76faa8ULL, 0x1d4f0bc7c7bbdcf9ULL, 0x3159b4cd4be0518aULL,
    0x647378d9c97e9fc8ULL, 0xc3ebd33483acc5eaULL, 0xeb6313faffa081c5ULL,
    0x49daf0b751dd0d17ULL, 0x9e68d429265516d3ULL, 0xfca1477d58be162bULL,
    0xce31d07ad1b8f88fULL, 0x280416958f3acb45ULL, 0x7e404bbbcafbd7afULL,
};

// The secret's 64-bit word at byte offset off (0 <= off <= 184).  Called
// only where its value initialises a constexpr variable, as CUDA requires
// for reading a constexpr array in device code.
MALVA_HDC uint64_t secret64(int off) {
  return (off & 7) == 0 ? kSecret[off >> 3]
                        : (kSecret[off >> 3] >> (8 * (off & 7))) |
                              (kSecret[(off >> 3) + 1] << (64 - 8 * (off & 7)));
}

MALVA_HD uint64_t mul128_fold64(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
  return (a * b) ^ __umul64hi(a, b);
#else
  __uint128_t p = (__uint128_t)a * b;
  return (uint64_t)p ^ (uint64_t)(p >> 64);
#endif
}

MALVA_HD uint64_t swap64(uint64_t x) {
  x = ((x & 0x00FF00FF00FF00FFULL) << 8) | ((x >> 8) & 0x00FF00FF00FF00FFULL);
  x = ((x & 0x0000FFFF0000FFFFULL) << 16) | ((x >> 16) & 0x0000FFFF0000FFFFULL);
  return (x << 32) | (x >> 32);
}

MALVA_HD uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

MALVA_HD uint64_t xxh64_avalanche(uint64_t h) {
  h ^= h >> 33;
  h *= PRIME64_2;
  h ^= h >> 29;
  h *= PRIME64_3;
  h ^= h >> 32;
  return h;
}

MALVA_HD uint64_t xxh3_avalanche(uint64_t h) {
  h ^= h >> 37;
  h *= PRIME_MX1;
  h ^= h >> 32;
  return h;
}

MALVA_HD uint64_t rrmxmx(uint64_t h, uint64_t len) {
  h ^= rotl64(h, 49) ^ rotl64(h, 24);
  h *= PRIME_MX2;
  h ^= (h >> 35) + len;
  h *= PRIME_MX2;
  return h ^ (h >> 28);
}

// The low 32 bits of (hi:lo) >> s, and the high 32 bits of (hi:lo) << s,
// for 0 <= s < 32.
MALVA_HD uint32_t funnel_r(uint32_t lo, uint32_t hi, uint32_t s) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, s);
#else
  return s == 0 ? lo : (lo >> s) | (hi << (32 - s));
#endif
}

MALVA_HD uint32_t funnel_l(uint32_t lo, uint32_t hi, uint32_t s) {
#ifdef __CUDA_ARCH__
  return __funnelshift_l(lo, hi, s);
#else
  return s == 0 ? hi : (hi << s) | (lo >> (32 - s));
#endif
}

// A byte string in memory, read a byte at a time.
struct BytePtr {
  static constexpr int kMaxLen = 240;
  const uint8_t* p;
  MALVA_HD uint32_t r8(int o) const { return p[o]; }
  MALVA_HD uint32_t r32(int o) const {
    return p[o] | (uint32_t)p[o + 1] << 8 | (uint32_t)p[o + 2] << 16 | (uint32_t)p[o + 3] << 24;
  }
  MALVA_HD uint64_t r64(int o) const { return r32(o) | (uint64_t)r32(o + 4) << 32; }
};

// mix16 of the 16 input bytes at offset o with the secret at byte S.
template <int S, class R>
MALVA_HD uint64_t mix16(const R& in, int o) {
  constexpr uint64_t s0 = secret64(S), s1 = secret64(S + 8);
  return mul128_fold64(in.r64(o) ^ s0, in.r64(o + 8) ^ s1);
}

// 129..240 bytes: the first eight stripes, then stripes 8.. below len / 16.
template <class R, int... I>
MALVA_HD uint64_t mix_head(const R& in, std::integer_sequence<int, I...>) {
  return (uint64_t{0} + ... + mix16<16 * I>(in, 16 * I));
}

template <class R, int... I>
MALVA_HD uint64_t mix_tail(const R& in, int len, std::integer_sequence<int, I...>) {
  return (uint64_t{0} + ... + (I + 8 < len / 16 ? mix16<16 * I + 3>(in, 16 * (I + 8)) : 0));
}

// XXH3_64bits of the first len (0..240) bytes of a reader's input.
template <class R>
MALVA_HD uint64_t xxh3_64(const R& in, int len) {
  if (len == 0) {
    constexpr uint64_t s = secret64(56) ^ secret64(64);
    return xxh64_avalanche(s);
  }
  if (len <= 3) {
    constexpr uint64_t s = (secret64(0) ^ secret64(4)) & 0xFFFFFFFFULL;
    const uint64_t c1 = in.r8(0), c2 = in.r8(len >> 1), c3 = in.r8(len - 1);
    const uint64_t combined = (c1 << 16) | (c2 << 24) | c3 | ((uint64_t)len << 8);
    return xxh64_avalanche(combined ^ s);
  }
  if (len <= 8) {
    constexpr uint64_t s = secret64(8) ^ secret64(16);
    const uint64_t in64 = in.r32(len - 4) + ((uint64_t)in.r32(0) << 32);
    return rrmxmx(in64 ^ s, (uint64_t)len);
  }
  if (len <= 16) {
    constexpr uint64_t s_lo = secret64(24) ^ secret64(32), s_hi = secret64(40) ^ secret64(48);
    const uint64_t lo = in.r64(0) ^ s_lo;
    const uint64_t hi = in.r64(len - 8) ^ s_hi;
    return xxh3_avalanche((uint64_t)len + swap64(lo) + hi + mul128_fold64(lo, hi));
  }
  constexpr int kMax = R::kMaxLen;
  uint64_t acc = (uint64_t)len * PRIME64_1;
  if (kMax <= 128 || len <= 128) {
    if (kMax > 96 && len > 96) acc += mix16<96>(in, 48) + mix16<112>(in, len - 64);
    if (kMax > 64 && len > 64) acc += mix16<64>(in, 32) + mix16<80>(in, len - 48);
    if (kMax > 32 && len > 32) acc += mix16<32>(in, 16) + mix16<48>(in, len - 32);
    acc += mix16<0>(in, 0) + mix16<16>(in, len - 16);
    return xxh3_avalanche(acc);
  }
  acc = xxh3_avalanche(acc + mix_head(in, std::make_integer_sequence<int, 8>{}));
  acc += mix_tail(in, len, std::make_integer_sequence<int, 7>{});
  acc += mix16<136 - 17>(in, len - 16);
  return xxh3_avalanche(acc);
}

// RCN complement (bloom_filter.hpp:36-50 upstream, incl. 'g' -> 'G');
// every other byte complements to NUL.
MALVA_HD uint8_t rcn(uint8_t c) {
  switch (c) {
    case 'A': case 'a': return 'T';
    case 'C': case 'c': return 'G';
    case 'G': case 'g': return c == 'G' ? 'C' : 'G';
    case 'N': case 'n': return 'N';
    case 'T': case 't': return 'A';
    default: return 0;
  }
}

// hash % size_bits for the device Bloom-size contract: a power of two,
// or n_gib * 2^33 with n_gib <= 8 (then the 64-bit modulo collapses to a
// 32-bit one on hash >> 33).
MALVA_HD uint64_t bloom_index(uint64_t h, uint64_t size_bits) {
  if ((size_bits & (size_bits - 1)) == 0) return h & (size_bits - 1);
  uint32_t n_gib = (uint32_t)(size_bits >> 33);
  uint64_t q = (uint32_t)(h >> 33) % n_gib;
  return (q << 33) | (h & ((1ULL << 33) - 1));
}

MALVA_HD uint32_t popc32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return (uint32_t)__builtin_popcount(x);
#endif
}

}  // namespace malva
