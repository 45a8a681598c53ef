// XXH3_64bits (seed 0, default secret) for one short input, header-only,
// __host__ __device__.  Lengths 0..240: the genotyper hashes k-mers and
// contexts of at most 240 bytes (k = 35, ref_k = 43 take the 17..128
// path).  Host spec: native/host_kernels.cpp:469 xxh3_one; the 128-bit
// product of mix16 uses __umul64hi on the device.
//
// Also holds the other per-lane helpers the kernels share: the RCN
// complement, the Bloom index (hash % size_bits) and the uint32 popcount.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define MALVA_HD __host__ __device__ __forceinline__
#else
#define MALVA_HD inline
#endif

namespace malva {

constexpr uint64_t PRIME32_1 = 0x9E3779B1ULL;
constexpr uint64_t PRIME64_1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t PRIME64_2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t PRIME64_3 = 0x165667B19E3779F9ULL;
constexpr uint64_t PRIME_MX1 = 0x165667919E3779F9ULL;
constexpr uint64_t PRIME_MX2 = 0x9FB21C651E98DF25ULL;

#define MALVA_SECRET_BYTES                                                     \
  {0xb8, 0xfe, 0x6c, 0x39, 0x23, 0xa4, 0x4b, 0xbe, 0x7c, 0x01, 0x81, 0x2c,     \
   0xf7, 0x21, 0xad, 0x1c, 0xde, 0xd4, 0x6d, 0xe9, 0x83, 0x90, 0x97, 0xdb,     \
   0x72, 0x40, 0xa4, 0xa4, 0xb7, 0xb3, 0x67, 0x1f, 0xcb, 0x79, 0xe6, 0x4e,     \
   0xcc, 0xc0, 0xe5, 0x78, 0x82, 0x5a, 0xd0, 0x7d, 0xcc, 0xff, 0x72, 0x21,     \
   0xb8, 0x08, 0x46, 0x74, 0xf7, 0x43, 0x24, 0x8e, 0xe0, 0x35, 0x90, 0xe6,     \
   0x81, 0x3a, 0x26, 0x4c, 0x3c, 0x28, 0x52, 0xbb, 0x91, 0xc3, 0x00, 0xcb,     \
   0x88, 0xd0, 0x65, 0x8b, 0x1b, 0x53, 0x2e, 0xa3, 0x71, 0x64, 0x48, 0x97,     \
   0xa2, 0x0d, 0xf9, 0x4e, 0x38, 0x19, 0xef, 0x46, 0xa9, 0xde, 0xac, 0xd8,     \
   0xa8, 0xfa, 0x76, 0x3f, 0xe3, 0x9c, 0x34, 0x3f, 0xf9, 0xdc, 0xbb, 0xc7,     \
   0xc7, 0x0b, 0x4f, 0x1d, 0x8a, 0x51, 0xe0, 0x4b, 0xcd, 0xb4, 0x59, 0x31,     \
   0xc8, 0x9f, 0x7e, 0xc9, 0xd9, 0x78, 0x73, 0x64, 0xea, 0xc5, 0xac, 0x83,     \
   0x34, 0xd3, 0xeb, 0xc3, 0xc5, 0x81, 0xa0, 0xff, 0xfa, 0x13, 0x63, 0xeb,     \
   0x17, 0x0d, 0xdd, 0x51, 0xb7, 0xf0, 0xda, 0x49, 0xd3, 0x16, 0x55, 0x26,     \
   0x29, 0xd4, 0x68, 0x9e, 0x2b, 0x16, 0xbe, 0x58, 0x7d, 0x47, 0xa1, 0xfc,     \
   0x8f, 0xf8, 0xb8, 0xd1, 0x7a, 0xd0, 0x31, 0xce, 0x45, 0xcb, 0x3a, 0x8f,     \
   0x95, 0x16, 0x04, 0x28, 0xaf, 0xd7, 0xfb, 0xca, 0xbb, 0x4b, 0x40, 0x7e}

// One copy per translation unit: the constant cache broadcasts the
// secret, whose offsets are the same for every thread of a warp.
#ifdef __CUDACC__
static __constant__ uint8_t kSecretDev[192] = MALVA_SECRET_BYTES;
#endif
static const uint8_t kSecretHost[192] = MALVA_SECRET_BYTES;

MALVA_HD uint8_t secret_byte(int i) {
#ifdef __CUDA_ARCH__
  return kSecretDev[i];
#else
  return kSecretHost[i];
#endif
}

MALVA_HD uint64_t sec64(int off) {
  uint64_t v = 0;
  for (int j = 7; j >= 0; --j) v = (v << 8) | secret_byte(off + j);
  return v;
}

MALVA_HD uint64_t sec32(int off) {
  uint64_t v = 0;
  for (int j = 3; j >= 0; --j) v = (v << 8) | secret_byte(off + j);
  return v;
}

// little-endian reads from a byte buffer (no alignment assumed)
MALVA_HD uint64_t rd64(const uint8_t* p) {
  uint64_t v = 0;
  for (int j = 7; j >= 0; --j) v = (v << 8) | p[j];
  return v;
}

MALVA_HD uint64_t rd32(const uint8_t* p) {
  return (uint64_t)p[0] | ((uint64_t)p[1] << 8) | ((uint64_t)p[2] << 16) |
         ((uint64_t)p[3] << 24);
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

MALVA_HD uint64_t mix16(const uint8_t* in, int sec_off) {
  return mul128_fold64(rd64(in) ^ sec64(sec_off), rd64(in + 8) ^ sec64(sec_off + 8));
}

// XXH3_64bits(a, len) for 0 <= len <= 240.
MALVA_HD uint64_t xxh3_64(const uint8_t* a, int len) {
  if (len == 0) return xxh64_avalanche(sec64(56) ^ sec64(64));
  if (len <= 3) {
    uint64_t c1 = a[0], c2 = a[len >> 1], c3 = a[len - 1];
    uint64_t combined = (c1 << 16) | (c2 << 24) | c3 | ((uint64_t)len << 8);
    return xxh64_avalanche(combined ^ (sec32(0) ^ sec32(4)));
  }
  if (len <= 8) {
    uint64_t in64 = rd32(a + len - 4) + (rd32(a) << 32);
    return rrmxmx(in64 ^ (sec64(8) ^ sec64(16)), (uint64_t)len);
  }
  if (len <= 16) {
    uint64_t lo = rd64(a) ^ (sec64(24) ^ sec64(32));
    uint64_t hi = rd64(a + len - 8) ^ (sec64(40) ^ sec64(48));
    return xxh3_avalanche((uint64_t)len + swap64(lo) + hi + mul128_fold64(lo, hi));
  }
  uint64_t acc = (uint64_t)len * PRIME64_1;
  if (len <= 128) {
    if (len > 96) acc += mix16(a + 48, 96) + mix16(a + len - 64, 112);
    if (len > 64) acc += mix16(a + 32, 64) + mix16(a + len - 48, 80);
    if (len > 32) acc += mix16(a + 16, 32) + mix16(a + len - 32, 48);
    acc += mix16(a, 0) + mix16(a + len - 16, 16);
    return xxh3_avalanche(acc);
  }
  for (int i = 0; i < 8; ++i) acc += mix16(a + 16 * i, 16 * i);
  acc = xxh3_avalanche(acc);
  for (int i = 8; i < len / 16; ++i) acc += mix16(a + 16 * i, 16 * (i - 8) + 3);
  acc += mix16(a + len - 16, 136 - 17);
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
