// Native host kernels for the variant-block engine: malva_tpu_torch's own
// copy of the JAX package's host library source, so that the port builds
// from its own files (malva_tpu_torch/utils/native.py compiles it at first
// use; see there for where it builds and how it gets its threads).
//
// The combination growth of the genotyper (grow left/right with
// back-tracking, then cross-product through the center variant —
// semantics of reference var_block.hpp:436-677, as mirrored by
// malva_tpu_torch/variants/blocks.py) is pure integer work on tiny arrays but
// runs once per variant and dominates the Python host profile on dense
// VCFs.  This module exposes it via a C ABI for ctypes.
//
// Build: malva_tpu_torch/utils/native.py, with -fopenmp where it can.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>
#if defined(_OPENMP)
#include <omp.h>
#include <parallel/algorithm>
#endif

using std::size_t;

namespace {

struct V {
  int64_t pos, size, min_size;
  uint8_t present;
};

inline bool overlapping(const V& a, const V& b) {
  return a.pos <= b.pos && b.pos < a.pos + a.size;
}

inline bool near_rl(const V& a, const V& b, int64_t k, int64_t sum) {
  // var_block.hpp:417-423: a is the left variant, b the right one
  return a.pos + a.size - a.min_size - 1 + sum + (k + 1) / 2 >= b.pos;
}

// grow combinations outward from `center`; dir=+1 right, -1 left.
// Mirrors blocks.py _grow_combs exactly (including the halt rule and the
// clean stop when back-tracking empties a combination).
void grow(const std::vector<V>& vs, int64_t center, int64_t k, int dir,
          std::vector<std::vector<int32_t>>& combs) {
  const V& mid = vs[center];
  std::vector<int64_t> sums;
  int64_t n = (int64_t)vs.size();

  for (int64_t j = center + dir; j >= 0 && j < n; j += dir) {
    const V& curr = vs[j];
    if (!curr.present) continue;
    if (dir > 0 ? overlapping(mid, curr) : overlapping(curr, mid)) continue;

    auto is_near = [&](int64_t s) {
      return dir > 0 ? near_rl(mid, curr, k, s) : near_rl(curr, mid, k, s);
    };
    auto tail_overlaps = [&](const std::vector<int32_t>& c) {
      const V& last = vs[c.back()];
      return dir > 0 ? overlapping(last, curr) : overlapping(curr, last);
    };

    if (combs.empty()) {
      if (is_near(0)) {
        combs.push_back({(int32_t)j});
        sums.push_back(curr.size - curr.min_size);
      }
      continue;
    }

    bool added = false;
    size_t n_existing = combs.size();
    for (size_t c = 0; c < n_existing; ++c) {
      if (!tail_overlaps(combs[c])) {
        added = true;
        if (is_near(sums[c])) {
          combs[c].push_back((int32_t)j);
          sums[c] += curr.size - curr.min_size;
        }
      }
    }
    if (!added) {
      std::vector<std::vector<int32_t>> ncombs;
      std::vector<int64_t> nsums;
      for (size_t c = 0; c < n_existing; ++c) {
        std::vector<int32_t> nc = combs[c];
        int64_t ns = sums[c];
        while (!nc.empty() && tail_overlaps(nc)) {
          const V& popped = vs[nc.back()];
          nc.pop_back();
          ns -= popped.size - popped.min_size;
        }
        nc.push_back((int32_t)j);
        if (is_near(ns)) {
          added = true;
          ncombs.push_back(nc);
          nsums.push_back(ns + curr.size - curr.min_size);
        }
      }
      for (size_t c = 0; c < ncombs.size(); ++c) {
        combs.push_back(std::move(ncombs[c]));
        sums.push_back(nsums[c]);
      }
      if (!added) break;  // halt: nothing further can be near
    }
  }
}

}  // namespace

extern "C" {

// GT parsing over a VCF record's sample region (the tab-joined columns
// 10+).  Mirrors malva_tpu_torch/io/vcf.py::_encode_gt / _genotypes_flat_slow
// exactly: htslib encoding ((allele+1)<<1 | phased-of-preceding-sep,
// '.'/'' -> 0|phase), a leading separator donates its phase to the first
// allele, max ploidy spans ALL samples, shorter samples pad with
// VECTOR_END.  This covers the irregular FORMATs (GT:DP:..., GT not
// first, multi-digit alleles) the numpy fast path can't.
//
// out must hold n_samples * max_ploidy_cap int32.  Rows are written at
// stride max_ploidy_cap; the caller slices to the returned max_ploidy.
// Returns max_ploidy, or -1 on any malformed input (caller falls back to
// the Python path, preserving its exception behavior).

extern "C" int64_t malva_parse_gt(const uint8_t* s, int64_t len,
                                  int64_t n_samples, int64_t gt_at,
                                  int32_t* out, int64_t cap) {
  const int32_t kVectorEnd = (int32_t)0x80000000;
  int64_t i = 0;
  int64_t max_ploidy = 0;
  for (int64_t smp = 0; smp < n_samples; ++smp) {
    // seek to the GT subfield
    for (int64_t f = 0; f < gt_at; ++f) {
      while (i < len && s[i] != ':' && s[i] != '\t') ++i;
      if (i >= len || s[i] != ':') return -1;
      ++i;
    }
    int32_t* row = out + smp * cap;
    int64_t p = 0;
    int phase = 0;
    if (i < len && (s[i] == '|' || s[i] == '/')) {
      // leading separator: its phase attaches to the first allele
      phase = (s[i] == '|');
      ++i;
    }
    while (true) {
      // one allele token: digits, or '.'/'' (missing)
      int32_t enc;
      if (i < len && s[i] == '.') {
        enc = 0 | phase;
        ++i;
      } else if (i < len && s[i] >= '0' && s[i] <= '9') {
        int64_t a = 0;
        while (i < len && s[i] >= '0' && s[i] <= '9') {
          a = a * 10 + (s[i] - '0');
          if (a > (1 << 29)) return -1;
          ++i;
        }
        enc = (int32_t)(((a + 1) << 1) | phase);
      } else if (i >= len || s[i] == '\t' || s[i] == ':' || s[i] == '|' ||
                 s[i] == '/') {
        enc = 0 | phase;  // empty token
      } else {
        return -1;  // unexpected character in GT
      }
      if (p >= cap) return -1;
      row[p++] = enc;
      if (i >= len || s[i] == '\t' || s[i] == ':') break;
      if (s[i] == '|' || s[i] == '/') {
        phase = (s[i] == '|');
        ++i;
        continue;
      }
      return -1;
    }
    if (p > max_ploidy) max_ploidy = p;
    // skip the rest of this sample's column
    while (i < len && s[i] != '\t') ++i;
    if (smp + 1 < n_samples) {
      if (i >= len || s[i] != '\t') return -1;
      ++i;
    }
    // pad the row
    for (int64_t q = p; q < cap; ++q) row[q] = kVectorEnd;
  }
  if (i < len) return -1;  // trailing garbage / sample count mismatch
  return max_ploidy;
}

// Genotype likelihoods for a batch of variants (semantics of reference
// var_block.hpp:224-330 as mirrored by malva_tpu_torch/models/genotype_host.py).
// Bit-exactness requires libm log/exp in double with float32 operand
// pre-rounding exactly where the C++ reference has float expressions —
// this kernel IS that C++, so parity is by construction (and fuzz-gated).
//
// Inputs are flattened per-variant arrays: variant v owns
// cov[off[v]:off[v+1]] and freqs[same range]; n_all = off[v+1]-off[v].
// Outputs: mode[v] (0 = normal probabilities, 1 = over-coverage guard,
// 2 = single-allele, 3 = zero total coverage), n_out[v] = number of
// emitted entries, probs = concatenated normal-mode probabilities in
// genotype order (haploid: g ascending; diploid: (g1,g2) with g2 >= g1,
// g1 outer).  For mode 1, n_out = number of over-covered alleles.
// Returns total probs written, or -1 if max_probs would be exceeded.

#include <cmath>

namespace {

// The reference is C++: `log(float_expr)` resolves to the FLOAT overload
// (logf), so priors and per-term posteriors are float32 all the way
// through the multiply, widening to double only at the additive
// accumulation (var_block.hpp:275-317 with float `frequencies` /
// `error_rate`).  Verified against the oracle to the last bit on the
// verbose (-v) 6-decimal rendering, which exposes sub-GQ differences.
inline float xlogf(float x) {
  if (x == 0.0f) return -INFINITY;
  if (x < 0.0f) return NAN;
  return std::log(x);  // float overload == logf, same libm as the oracle
}

inline double log_binomial(int64_t n, int64_t k) {
  if (n == 0 || n == k || k == 0) return 0.0;
  double dn = (double)n, dk = (double)k, dr = (double)(n - k);
  return dn * std::log(dn) - dk * std::log(dk) - dr * std::log(dr);
}

inline double store(double lp) { return std::isinf(lp) ? 0.0 : std::exp(lp); }

}  // namespace

extern "C" {

int64_t malva_genotype_block(const int64_t* cov, const float* freqs,
                             const int64_t* off, int64_t n_var,
                             int haploid, int64_t max_cov, float er,
                             int8_t* mode, int32_t* n_out,
                             double* probs, int64_t max_probs) {
  int64_t w = 0;
  for (int64_t v = 0; v < n_var; ++v) {
    const int64_t* c = cov + off[v];
    const float* f = freqs + off[v];
    int64_t n_all = off[v + 1] - off[v];

    int32_t over = 0;
    for (int64_t i = 0; i < n_all; ++i)
      if (c[i] > max_cov) ++over;
    if (over) { mode[v] = 1; n_out[v] = over; continue; }
    if (n_all == 1) { mode[v] = 2; n_out[v] = 1; continue; }

    int64_t total = 0;
    for (int64_t i = 0; i < n_all; ++i) total += c[i];
    if (total == 0) { mode[v] = 3; n_out[v] = 1; continue; }

    mode[v] = 0;
    if (haploid) {
      if (w + n_all > max_probs) return -1;
      for (int64_t g1 = 0; g1 < n_all; ++g1) {
        int64_t truth = c[g1], error = total - truth;
        double log_prior = 2 * xlogf(f[g1]);           // int*float -> float
        double log_post = log_binomial(truth + error, truth)
            + (float)truth * xlogf(1.0f - er)          // float multiplies,
            + (float)error * xlogf(er / (float)(n_all - 1));  // double adds
        probs[w++] = store(log_prior + log_post);
      }
      n_out[v] = (int32_t)n_all;
    } else {
      int64_t cnt = n_all * (n_all + 1) / 2;
      if (w + cnt > max_probs) return -1;
      for (int64_t g1 = 0; g1 < n_all; ++g1) {
        for (int64_t g2 = g1; g2 < n_all; ++g2) {
          double log_prior, log_post;
          if (g1 == g2) {
            log_prior = 2 * xlogf(f[g1]);
            int64_t truth = c[g1], error = total - truth;
            log_post = log_binomial(truth + error, truth)
                + (float)truth * xlogf(1.0f - er)
                + (float)error * xlogf(er / (float)(n_all - 1));
          } else {
            log_prior = xlogf(2.0f * f[g1] * f[g2]);
            int64_t t1 = c[g1], t2 = c[g2];
            int64_t error = total - t1 - t2;
            log_post = log_binomial(t1 + t2 + error, t1 + t2)
                + log_binomial(t1 + t2, t1)
                + (float)t1 * xlogf((1.0f - er) / 2.0f)
                + (float)t2 * xlogf((1.0f - er) / 2.0f);
            if (n_all > 2)
              log_post += (float)error * xlogf(er / (float)(n_all - 2));
          }
          probs[w++] = store(log_prior + log_post);
        }
      }
      n_out[v] = (int32_t)cnt;
    }
  }
  return w;
}

}  // extern "C"

// Exclusive popcount scan over the Bloom bit words: rank[i] = number of
// set bits in words[0..i).  This is the rank_support_v rebuild the
// genotyper does at switch_mode/load (reference bloom_filter.hpp:93-98);
// one memory-bandwidth-bound pass here replaces numpy's bitwise_count +
// cumsum double pass.  Returns the total popcount.
// Read-only popcount total (no rank array): the context filter only
// needs its set-bit count, and on this class of VM first-touch write
// faults cost ~40us/page — a 1 GiB rank array is ~13 s of faults.
uint64_t malva_popcount_sum(const uint32_t* words, int64_t n) {
  uint64_t acc = 0;
#pragma omp parallel for schedule(static) reduction(+ : acc) if (n > (1 << 20))
  for (int64_t i = 0; i < n; ++i) acc += (uint64_t)__builtin_popcount(words[i]);
  return acc;
}

// Exclusive popcount scan.  Two passes so the rank writes (and their
// first-touch page faults) run in parallel: per-block partial sums,
// serial block scan, parallel fill.
uint64_t malva_bf_rank(const uint32_t* words, int64_t n, uint32_t* rank) {
  const int64_t BLK = 1 << 18;
  const int64_t nb = (n + BLK - 1) / BLK;
  std::vector<uint64_t> bsum(nb + 1, 0);
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < nb; ++b) {
    uint64_t s = 0;
    const int64_t hi = std::min(n, (b + 1) * BLK);
    for (int64_t i = b * BLK; i < hi; ++i)
      s += (uint64_t)__builtin_popcount(words[i]);
    bsum[b + 1] = s;
  }
  for (int64_t b = 0; b < nb; ++b) bsum[b + 1] += bsum[b];
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < nb; ++b) {
    uint64_t acc = bsum[b];
    const int64_t hi = std::min(n, (b + 1) * BLK);
    for (int64_t i = b * BLK; i < hi; ++i) {
      rank[i] = (uint32_t)acc;
      acc += (uint64_t)__builtin_popcount(words[i]);
    }
  }
  return bsum[nb];
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batch sequence kernels: XXH3, canonicalization, 2-bit packing.
//
// These are the big-array host ops of the pipeline (counting flush,
// BF/KMAP query batches — the per-k-mer work of reference main.cpp:487-500
// done host-side).  The XXH3 implementation below is written from the
// public XXH3 specification, mirroring malva_tpu_torch/ops/xxh3.py (same
// structure, same constants); it is NOT the vendored upstream xxhash.c.
// Parity with the Python path is enforced by tests/test_xxh3.py and the
// native-parity fuzz in tests/test_seq.py.
// ---------------------------------------------------------------------------

#include <cstring>

namespace {

constexpr uint64_t PRIME32_1 = 0x9E3779B1ULL;
constexpr uint64_t PRIME32_2 = 0x85EBCA77ULL;
constexpr uint64_t PRIME32_3 = 0xC2B2AE3DULL;
constexpr uint64_t PRIME64_1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t PRIME64_2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t PRIME64_3 = 0x165667B19E3779F9ULL;
constexpr uint64_t PRIME64_4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t PRIME64_5 = 0x27D4EB2F165667C5ULL;
constexpr uint64_t PRIME_MX1 = 0x165667919E3779F9ULL;
constexpr uint64_t PRIME_MX2 = 0x9FB21C651E98DF25ULL;

// 192-byte canonical XXH3 default secret (spec constant).
const uint8_t kSecret[192] = {
    0xB8, 0xFE, 0x6C, 0x39, 0x23, 0xA4, 0x4B, 0xBE, 0x7C, 0x01, 0x81, 0x2C, 0xF7, 0x21, 0xAD, 0x1C,
    0xDE, 0xD4, 0x6D, 0xE9, 0x83, 0x90, 0x97, 0xDB, 0x72, 0x40, 0xA4, 0xA4, 0xB7, 0xB3, 0x67, 0x1F,
    0xCB, 0x79, 0xE6, 0x4E, 0xCC, 0xC0, 0xE5, 0x78, 0x82, 0x5A, 0xD0, 0x7D, 0xCC, 0xFF, 0x72, 0x21,
    0xB8, 0x08, 0x46, 0x74, 0xF7, 0x43, 0x24, 0x8E, 0xE0, 0x35, 0x90, 0xE6, 0x81, 0x3A, 0x26, 0x4C,
    0x3C, 0x28, 0x52, 0xBB, 0x91, 0xC3, 0x00, 0xCB, 0x88, 0xD0, 0x65, 0x8B, 0x1B, 0x53, 0x2E, 0xA3,
    0x71, 0x64, 0x48, 0x97, 0xA2, 0x0D, 0xF9, 0x4E, 0x38, 0x19, 0xEF, 0x46, 0xA9, 0xDE, 0xAC, 0xD8,
    0xA8, 0xFA, 0x76, 0x3F, 0xE3, 0x9C, 0x34, 0x3F, 0xF9, 0xDC, 0xBB, 0xC7, 0xC7, 0x0B, 0x4F, 0x1D,
    0x8A, 0x51, 0xE0, 0x4B, 0xCD, 0xB4, 0x59, 0x31, 0xC8, 0x9F, 0x7E, 0xC9, 0xD9, 0x78, 0x73, 0x64,
    0xEA, 0xC5, 0xAC, 0x83, 0x34, 0xD3, 0xEB, 0xC3, 0xC5, 0x81, 0xA0, 0xFF, 0xFA, 0x13, 0x63, 0xEB,
    0x17, 0x0D, 0xDD, 0x51, 0xB7, 0xF0, 0xDA, 0x49, 0xD3, 0x16, 0x55, 0x26, 0x29, 0xD4, 0x68, 0x9E,
    0x2B, 0x16, 0xBE, 0x58, 0x7D, 0x47, 0xA1, 0xFC, 0x8F, 0xF8, 0xB8, 0xD1, 0x7A, 0xD0, 0x31, 0xCE,
    0x45, 0xCB, 0x3A, 0x8F, 0x95, 0x16, 0x04, 0x28, 0xAF, 0xD7, 0xFB, 0xCA, 0xBB, 0x4B, 0x40, 0x7E,
};

inline uint64_t rd64(const uint8_t* p) { uint64_t v; std::memcpy(&v, p, 8); return v; }
inline uint64_t rd32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return (uint64_t)v; }
inline uint64_t sec64(int off) { return rd64(kSecret + off); }
inline uint64_t sec32(int off) { return rd32(kSecret + off); }

inline uint64_t mul128_fold64(uint64_t a, uint64_t b) {
  __uint128_t p = (__uint128_t)a * b;
  return (uint64_t)p ^ (uint64_t)(p >> 64);
}
inline uint64_t swap64(uint64_t x) { return __builtin_bswap64(x); }
inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t xxh64_avalanche(uint64_t h) {
  h ^= h >> 33; h *= PRIME64_2; h ^= h >> 29; h *= PRIME64_3; h ^= h >> 32;
  return h;
}
inline uint64_t xxh3_avalanche(uint64_t h) {
  h ^= h >> 37; h *= PRIME_MX1; h ^= h >> 32;
  return h;
}
inline uint64_t rrmxmx(uint64_t h, uint64_t len) {
  h ^= rotl64(h, 49) ^ rotl64(h, 24);
  h *= PRIME_MX2;
  h ^= (h >> 35) + len;
  h *= PRIME_MX2;
  return h ^ (h >> 28);
}
inline uint64_t mix16(const uint8_t* in, int sec_off) {
  return mul128_fold64(rd64(in) ^ sec64(sec_off), rd64(in + 8) ^ sec64(sec_off + 8));
}

uint64_t xxh3_one(const uint8_t* a, int64_t len) {
  if (len == 0)
    return xxh64_avalanche(sec64(56) ^ sec64(64));
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
  if (len <= 128) {
    uint64_t acc = (uint64_t)len * PRIME64_1;
    if (len > 96) acc += mix16(a + 48, 96) + mix16(a + len - 64, 112);
    if (len > 64) acc += mix16(a + 32, 64) + mix16(a + len - 48, 80);
    if (len > 32) acc += mix16(a + 16, 32) + mix16(a + len - 32, 48);
    acc += mix16(a, 0) + mix16(a + len - 16, 16);
    return xxh3_avalanche(acc);
  }
  if (len <= 240) {
    uint64_t acc = (uint64_t)len * PRIME64_1;
    int64_t nb = len / 16;
    for (int i = 0; i < 8; ++i) acc += mix16(a + 16 * i, 16 * i);
    acc = xxh3_avalanche(acc);
    for (int64_t i = 8; i < nb; ++i) acc += mix16(a + 16 * i, 16 * (int)(i - 8) + 3);
    acc += mix16(a + len - 16, 136 - 17);
    return xxh3_avalanche(acc);
  }
  // long path: 64B stripes, 192B secret, scramble per block
  constexpr int kStripe = 64;
  constexpr int kSecretSize = 192;
  constexpr int kStripesPerBlock = (kSecretSize - kStripe) / 8;  // 16
  constexpr int kBlockLen = kStripe * kStripesPerBlock;
  uint64_t acc[8] = {PRIME32_3, PRIME64_1, PRIME64_2, PRIME64_3,
                     PRIME64_4, PRIME32_2, PRIME64_5, PRIME32_1};
  auto accumulate512 = [&](const uint8_t* in, int sec_off) {
    for (int i = 0; i < 8; ++i) {
      uint64_t dv = rd64(in + 8 * i);
      uint64_t dk = dv ^ sec64(sec_off + 8 * i);
      acc[i ^ 1] += dv;
      acc[i] += (dk & 0xFFFFFFFFULL) * (dk >> 32);
    }
  };
  int64_t nb_blocks = (len - 1) / kBlockLen;
  for (int64_t b = 0; b < nb_blocks; ++b) {
    for (int s = 0; s < kStripesPerBlock; ++s)
      accumulate512(a + b * kBlockLen + s * kStripe, 8 * s);
    for (int i = 0; i < 8; ++i) {
      uint64_t x = acc[i];
      acc[i] = (x ^ (x >> 47) ^ sec64(kSecretSize - kStripe + 8 * i)) * PRIME32_1;
    }
  }
  int64_t nb_stripes = ((len - 1) - (int64_t)kBlockLen * nb_blocks) / kStripe;
  for (int64_t s = 0; s < nb_stripes; ++s)
    accumulate512(a + nb_blocks * kBlockLen + s * kStripe, 8 * (int)s);
  accumulate512(a + len - kStripe, kSecretSize - kStripe - 7);
  uint64_t result = (uint64_t)len * PRIME64_1;
  for (int i = 0; i < 4; ++i) {
    int sec_off = 11 + 16 * i;
    result += mul128_fold64(acc[2 * i] ^ sec64(sec_off), acc[2 * i + 1] ^ sec64(sec_off + 8));
  }
  return xxh3_avalanche(result);
}

// RCN complement table (reference bloom_filter.hpp:36-50, incl. the
// 'g'->'G' upstream quirk; everything unmapped complements to 0).
struct RcnTable {
  uint8_t t[256];
  RcnTable() {
    std::memset(t, 0, sizeof(t));
    t['A'] = 'T'; t['C'] = 'G'; t['G'] = 'C'; t['N'] = 'N'; t['T'] = 'A';
    t['a'] = 'T'; t['c'] = 'G'; t['g'] = 'G'; t['n'] = 'N'; t['t'] = 'A';
  }
};
const RcnTable kRcn;

// canonical = fwd if fwd < revcomp(fwd) lexicographically else revcomp.
inline void canonical_row(const uint8_t* in, int64_t k, uint8_t* out) {
  // out := revcomp
  for (int64_t j = 0; j < k; ++j) out[j] = kRcn.t[in[k - 1 - j]];
  for (int64_t j = 0; j < k; ++j) {
    if (in[j] < out[j]) { std::memcpy(out, in, k); return; }
    if (in[j] > out[j]) return;
  }
  // tie: keep revcomp (== fwd bytewise)
}

}  // namespace

extern "C" {

// XXH3_64bits over n rows of fixed length len.
void malva_xxh3_batch(const uint8_t* data, int64_t n, int64_t len, uint64_t* out) {
#pragma omp parallel for schedule(static) if (n > 4096)
  for (int64_t i = 0; i < n; ++i) out[i] = xxh3_one(data + i * len, len);
}

// Canonical form of each row (min of row and its reverse complement,
// revcomp on ties — reference bloom_filter.hpp:58-65).
void malva_canonical(const uint8_t* in, int64_t n, int64_t k, uint8_t* out) {
#pragma omp parallel for schedule(static) if (n > 4096)
  for (int64_t i = 0; i < n; ++i) canonical_row(in + i * k, k, out + i * k);
}

// Fused canonical + XXH3 (the Bloom-filter key hash,
// bloom_filter.hpp:67-74) without materializing the canonical matrix.
void malva_canonical_xxh3(const uint8_t* in, int64_t n, int64_t k, uint64_t* out) {
#pragma omp parallel if (n > 4096)
  {
    std::vector<uint8_t> buf(k);
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      canonical_row(in + i * k, k, buf.data());
      out[i] = xxh3_one(buf.data(), k);
    }
  }
}

// 2-bit pack: base j of a row -> word j/32, bits 2*(31 - j%32)..+1, with
// non-ACGT bytes contributing code 255 exactly like the numpy path
// (callers pre-filter with is_acgt; the wrap-around garbage must still
// match bit-for-bit).
void malva_pack2bit(const uint8_t* in, int64_t n, int64_t k, uint64_t* out) {
  uint8_t code[256];
  std::memset(code, 255, sizeof(code));
  code['A'] = 0; code['C'] = 1; code['G'] = 2; code['T'] = 3;
  const int64_t nwords = (k + 31) / 32;
#pragma omp parallel for schedule(static) if (n > 4096)
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* row = in + i * k;
    uint64_t* orow = out + i * nwords;
    for (int64_t w = 0; w < nwords; ++w) {
      uint64_t acc = 0;
      int64_t j0 = w * 32, j1 = (w + 1) * 32 < k ? (w + 1) * 32 : k;
      for (int64_t j = j0; j < j1; ++j)
        acc |= (uint64_t)code[row[j]] << (2 * (31 - (j & 31)));
      orow[w] = acc;
    }
  }
}

// Per-allele coverage from flat per-k-mer counts (main.cpp:151-184):
// coverage = max over the allele's signatures of the incremental integer
// mean of the signature's nonzero counts.  ``w`` holds every queried
// k-mer's count in traversal order; ``sig_len`` the k-mers per signature;
// ``allele_nsig`` the signatures per allele (same order).  Exact mirror
// of the Python scan in malva_tpu_torch/pipeline.py::_set_coverages_group.
void malva_coverage(const int64_t* w, const int64_t* sig_len, int64_t n_sigs,
                    const int64_t* allele_nsig, int64_t n_alleles,
                    int64_t* out_cov) {
  std::vector<int64_t> sig_off(n_sigs + 1), al_off(n_alleles + 1);
  sig_off[0] = 0;
  for (int64_t s = 0; s < n_sigs; ++s) sig_off[s + 1] = sig_off[s] + sig_len[s];
  al_off[0] = 0;
  for (int64_t a = 0; a < n_alleles; ++a)
    al_off[a + 1] = al_off[a] + allele_nsig[a];
#pragma omp parallel for schedule(static) if (n_alleles > 1024)
  for (int64_t a = 0; a < n_alleles; ++a) {
    int64_t cov = 0;
    for (int64_t s = al_off[a]; s < al_off[a + 1]; ++s) {
      int64_t curr = 0, n = 0;
      for (int64_t i = sig_off[s]; i < sig_off[s + 1]; ++i) {
        if (w[i] > 0) { curr = (curr * n + w[i]) / (n + 1); ++n; }
      }
      if (curr > cov) cov = curr;
    }
    out_cov[a] = cov;
  }
}

// Zero every byte at/after the first NUL of each row (C-string key
// truncation of the exact map, reference kmap.hpp:95).
void malva_truncate_nul(const uint8_t* in, int64_t n, int64_t k, uint8_t* out) {
#pragma omp parallel for schedule(static) if (n > 4096)
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* row = in + i * k;
    uint8_t* orow = out + i * k;
    int64_t j = 0;
    for (; j < k && row[j]; ++j) orow[j] = row[j];
    for (; j < k; ++j) orow[j] = 0;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Host k-mer counting kernels (count/counter.py hot path).
//
// The KMC-replacement counter extracts every pure-ACGT k-window of each
// read, canonicalizes, 2-bit packs (32 bases per u64, big-endian within
// the word — the layout of ops/seq.py::pack_2bit), sorts and run-length
// counts.  The NumPy path materializes a (windows, k) byte matrix (a 25x
// blow-up of the read bytes) before packing; these kernels roll the
// packed forward/revcomp forms across each read instead, so the only
// traffic is read bytes in, (N, W) u64 keys out.  Bit-exact with the
// NumPy path by the parity tests.

namespace {

inline void roll_setup(int64_t k, int64_t& W, int64_t& top_word,
                       int64_t& top_shift, uint64_t& last_mask) {
  W = (k + 31) / 32;
  // base k-1 lives in word (k-1)/32 at bit offset 2*(31 - (k-1)%32)
  top_word = (k - 1) / 32;
  top_shift = 2 * (31 - ((k - 1) & 31));
  // bits at/above base k-1's offset in the last word are valid
  last_mask = ~((top_shift == 0) ? 0ULL : ((1ULL << top_shift) - 1ULL));
}

// counts[r] = number of pure-ACGT k-windows of read r
void count_windows_one(const uint8_t* s, int64_t len, int64_t k,
                       const uint8_t* code, int64_t& out) {
  out = 0;
  if (len < k) return;
  int64_t bad = 0;  // invalid bases in current window
  for (int64_t i = 0; i < len; ++i) {
    if (code[s[i]] == 255) bad = k;  // poisons the next k windows
    else if (bad > 0) --bad;
    if (i >= k - 1 && bad == 0) ++out;
  }
}

// emit packed canonical keys for one read at out (row-major (n, W))
void read_kmers_one(const uint8_t* s, int64_t len, int64_t k,
                    const uint8_t* code, uint64_t* out) {
  if (len < k) return;
  int64_t W, top_word, top_shift;
  uint64_t last_mask;
  roll_setup(k, W, top_word, top_shift, last_mask);
  std::vector<uint64_t> fwd(W, 0), rc(W, 0);
  int64_t bad = 0;
  for (int64_t i = 0; i < len; ++i) {
    uint8_t c = code[s[i]];
    uint64_t cf, cr;
    if (c == 255) { bad = k; cf = 0; cr = 3; }
    else { if (bad > 0) --bad; cf = c; cr = 3 - (uint64_t)c; }
    // fwd: shift left 2 (drop oldest at top of word 0), append at base k-1
    for (int64_t w = 0; w < W - 1; ++w)
      fwd[w] = (fwd[w] << 2) | (fwd[w + 1] >> 62);
    fwd[W - 1] <<= 2;
    fwd[top_word] |= cf << top_shift;
    // rc: shift right 2 (drop base k-1), insert complement at base 0
    for (int64_t w = W - 1; w > 0; --w)
      rc[w] = (rc[w] >> 2) | (rc[w - 1] << 62);
    rc[0] >>= 2;
    rc[0] |= cr << 62;
    rc[W - 1] &= last_mask;
    if (i >= k - 1 && bad == 0) {
      // canonical = lexicographic min; ties keep rc (identical bits)
      bool take_fwd = false;
      for (int64_t w = 0; w < W; ++w) {
        if (fwd[w] < rc[w]) { take_fwd = true; break; }
        if (fwd[w] > rc[w]) break;
      }
      const uint64_t* src = take_fwd ? fwd.data() : rc.data();
      for (int64_t w = 0; w < W; ++w) out[w] = src[w];
      out += W;
    }
  }
}

struct CodeTab {
  uint8_t t[256];
  CodeTab() {
    std::memset(t, 255, sizeof(t));
    t['A'] = t['a'] = 0; t['C'] = t['c'] = 1;
    t['G'] = t['g'] = 2; t['T'] = t['t'] = 3;
  }
};
const CodeTab kCode;

struct K2 { uint64_t hi, lo; };
inline bool k2_less(const K2& a, const K2& b) {
  return a.hi != b.hi ? a.hi < b.hi : a.lo < b.lo;
}

}  // namespace

extern "C" {

// Per-read pure-ACGT window counts (parallel over reads).
void malva_count_windows(const uint8_t* bytes, const int64_t* offs,
                         int64_t n_reads, int64_t k, int64_t* counts) {
#pragma omp parallel for schedule(dynamic, 64) if (n_reads > 256)
  for (int64_t r = 0; r < n_reads; ++r)
    count_windows_one(bytes + offs[r], offs[r + 1] - offs[r], k, kCode.t,
                      counts[r]);
}

// Packed canonical k-mers of every pure-ACGT window, read-order.
// out_offs[r] = row index where read r's keys start (from the counts
// above); out is ((total, W)) u64.
void malva_read_kmers(const uint8_t* bytes, const int64_t* offs,
                      const int64_t* out_offs, int64_t n_reads, int64_t k,
                      uint64_t* out) {
  const int64_t W = (k + 31) / 32;
#pragma omp parallel for schedule(dynamic, 64) if (n_reads > 256)
  for (int64_t r = 0; r < n_reads; ++r)
    read_kmers_one(bytes + offs[r], offs[r + 1] - offs[r], k, kCode.t,
                   out + out_offs[r] * W);
}

// Sort (n, W<=2) u64 rows lexicographically and run-length count:
// unique rows are compacted to the FRONT of keys, counts written per
// unique row; returns the number of unique rows.  (W==1 rows are
// widened by the caller with a zero low word.)
int64_t malva_sort_count(uint64_t* keys, int64_t n, int64_t* cnts) {
  if (n == 0) return 0;
  K2* a = reinterpret_cast<K2*>(keys);
#if defined(_OPENMP)
  __gnu_parallel::sort(a, a + n, k2_less);
#else
  std::sort(a, a + n, k2_less);
#endif
  int64_t u = 0;
  cnts[0] = 1;
  for (int64_t i = 1; i < n; ++i) {
    if (a[i].hi == a[u].hi && a[i].lo == a[u].lo) {
      ++cnts[u];
    } else {
      ++u;
      a[u] = a[i];
      cnts[u] = 1;
    }
  }
  return u + 1;
}

// Linear merge of two sorted distinct (key, count) runs, summing counts.
// Returns the merged length (<= na + nb).
int64_t malva_merge_runs(const uint64_t* ka, const int64_t* ca, int64_t na,
                         const uint64_t* kb, const int64_t* cb, int64_t nb,
                         uint64_t* ko, int64_t* co) {
  const K2* a = reinterpret_cast<const K2*>(ka);
  const K2* b = reinterpret_cast<const K2*>(kb);
  K2* o = reinterpret_cast<K2*>(ko);
  int64_t i = 0, j = 0, m = 0;
  while (i < na && j < nb) {
    if (k2_less(a[i], b[j])) { o[m] = a[i]; co[m++] = ca[i++]; }
    else if (k2_less(b[j], a[i])) { o[m] = b[j]; co[m++] = cb[j++]; }
    else { o[m] = a[i]; co[m++] = ca[i++] + cb[j++]; }
  }
  while (i < na) { o[m] = a[i]; co[m++] = ca[i++]; }
  while (j < nb) { o[m] = b[j]; co[m++] = cb[j++]; }
  return m;
}

// Stable partition of (n, w<=2) u64 key rows (+ u32 counts) into spill
// buckets — replaces the numpy argsort+double-gather in
// SpillStore.add_segment (was ~60% of segment commit time).  The bucket
// hash MUST stay bit-identical to count/spill.py _bucket_of: segments of
// one store may be written by either path (resume), and a key landing in
// different buckets across segments would be merged as two distinct keys
// (breaking the global ci threshold).  Rows keep input order within each
// bucket (the per-bucket merge relies on sorted runs).
void malva_bucket_partition(const uint64_t* keys, const uint32_t* cnts,
                            int64_t n, int64_t w, int64_t shift,
                            int64_t n_buckets, uint64_t* out_keys,
                            uint32_t* out_cnts, int64_t* offs) {
  const uint64_t M0 = 0x9E3779B97F4A7C15ULL, M1 = 0xC2B2AE3D27D4EB4FULL;
  int T = 1;
#if defined(_OPENMP)
  T = omp_get_max_threads();
#endif
  if (n < (int64_t)1 << 16) T = 1;
  const int64_t chunk = (n + T - 1) / T;
  std::vector<int64_t> hist((size_t)T * n_buckets, 0);
  auto bucket_of = [&](int64_t i) {
    uint64_t h = keys[i * w] * M0;
    if (w == 2) h ^= keys[i * w + 1] * M1;
    h *= M0;
    return (int64_t)(h >> shift);
  };
#pragma omp parallel for num_threads(T) schedule(static, 1)
  for (int t = 0; t < T; ++t) {
    const int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    int64_t* hh = hist.data() + (size_t)t * n_buckets;
    for (int64_t i = lo; i < hi; ++i) ++hh[bucket_of(i)];
  }
  // bucket-major exclusive offsets, chunk order preserved within bucket
  std::vector<int64_t> pos((size_t)T * n_buckets);
  int64_t acc = 0;
  for (int64_t b = 0; b < n_buckets; ++b) {
    offs[b] = acc;
    for (int t = 0; t < T; ++t) {
      pos[(size_t)t * n_buckets + b] = acc;
      acc += hist[(size_t)t * n_buckets + b];
    }
  }
  offs[n_buckets] = acc;
#pragma omp parallel for num_threads(T) schedule(static, 1)
  for (int t = 0; t < T; ++t) {
    const int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    int64_t* pp = pos.data() + (size_t)t * n_buckets;
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t o = pp[bucket_of(i)]++;
      out_keys[o * w] = keys[i * w];
      if (w == 2) out_keys[o * w + 1] = keys[i * w + 1];
      out_cnts[o] = cnts[i];
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Scatter primitives (numpy's unbuffered ufunc.at is ~10 M el/s; these
// run at memory speed — serial on purpose: updates may collide).

extern "C" {

void malva_scatter_add_u32(uint32_t* buf, const int64_t* idx,
                           const uint32_t* vals, int64_t n) {
  for (int64_t i = 0; i < n; ++i) buf[idx[i]] += vals[i];
}

void malva_scatter_or_u32(uint32_t* buf, const int64_t* idx,
                          const uint32_t* vals, int64_t n) {
  for (int64_t i = 0; i < n; ++i) buf[idx[i]] |= vals[i];
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Packed-context apply kernels (the host call-phase fast path,
// pipeline.apply_sample_counts over the counter's 2-bit packed output —
// the per-k-mer work of reference main.cpp:487-500 without ever
// materializing the ASCII matrices).

namespace {

inline void unpack_row(const uint64_t* row, int64_t k, uint8_t* out) {
  static const char kAlpha[4] = {'A', 'C', 'G', 'T'};
  for (int64_t j = 0; j < k; ++j)
    out[j] = kAlpha[(row[j >> 5] >> (2 * (31 - (j & 31)))) & 3];
}

inline void pack_row(const uint8_t* in, int64_t k, uint64_t* out) {
  const int64_t nwords = (k + 31) / 32;
  for (int64_t w = 0; w < nwords; ++w) {
    uint64_t acc = 0;
    const int64_t j1 = (w + 1) * 32 < k ? (w + 1) * 32 : k;
    for (int64_t j = w * 32; j < j1; ++j) {
      uint64_t c = in[j] == 'A' ? 0 : in[j] == 'C' ? 1 : in[j] == 'G' ? 2 : 3;
      acc |= c << (2 * (31 - (j & 31)));
    }
    out[w] = acc;
  }
}

// lexicographic row compare over w uint64 words (== ASCII k-mer order,
// see ops/seq.pack_2bit's layout contract)
inline int cmp_rows(const uint64_t* a, const uint64_t* b, int64_t w) {
  for (int64_t j = 0; j < w; ++j) {
    if (a[j] < b[j]) return -1;
    if (a[j] > b[j]) return 1;
  }
  return 0;
}

}  // namespace

extern "C" {

// Inverse of malva_pack2bit back to ASCII.
void malva_unpack2bit(const uint64_t* in, int64_t n, int64_t k, uint8_t* out) {
  const int64_t nwords = (k + 31) / 32;
#pragma omp parallel for schedule(static) if (n > 4096)
  for (int64_t i = 0; i < n; ++i) unpack_row(in + i * nwords, k, out + i * k);
}

// Fused per-context work of the host apply path: for each packed
// canonical ref_k-mer row, emit (a) XXH3 of its ASCII form (the context
// Bloom probe), (b) XXH3 of the canonical centered k-mer (the alt-BF
// probe), (c) the canonical centered k-mer 2-bit packed (the exact-map
// probe).  Everything per row stays in registers/stack.
void malva_apply_ctx_packed(const uint64_t* ctx, int64_t n, int64_t ref_k,
                            int64_t k, uint64_t* ctx_hash,
                            uint64_t* center_hash, uint64_t* center_packed) {
  const int64_t wctx = (ref_k + 31) / 32;
  const int64_t wc = (k + 31) / 32;
  const int64_t off = (ref_k - k) / 2;
#pragma omp parallel if (n > 4096)
  {
    std::vector<uint8_t> buf(ref_k), cbuf(k);
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      unpack_row(ctx + i * wctx, ref_k, buf.data());
      ctx_hash[i] = xxh3_one(buf.data(), ref_k);
      canonical_row(buf.data() + off, k, cbuf.data());
      center_hash[i] = xxh3_one(cbuf.data(), k);
      pack_row(cbuf.data(), k, center_packed + i * wc);
    }
  }
}

// Argsort of (n, w) uint64 rows in lexicographic row order.
void malva_argsort_u64rows(const uint64_t* a, int64_t n, int64_t w,
                           int64_t* perm) {
  for (int64_t i = 0; i < n; ++i) perm[i] = i;
  std::sort(perm, perm + n, [&](int64_t x, int64_t y) {
    return cmp_rows(a + x * w, a + y * w, w) < 0;
  });
}

// Exact-match binary search of each probe row in a sorted row array:
// pos[i] = index of the match, or -1.
void malva_search_u64rows(const uint64_t* sorted, int64_t m,
                          const uint64_t* probes, int64_t n, int64_t w,
                          int64_t* pos) {
#pragma omp parallel for schedule(static) if (n > 4096)
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t* p = probes + i * w;
    int64_t lo = 0, hi = m;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (cmp_rows(sorted + mid * w, p, w) < 0) lo = mid + 1;
      else hi = mid;
    }
    pos[i] = (lo < m && cmp_rows(sorted + lo * w, p, w) == 0) ? lo : -1;
  }
}

// Fused Bloom half of the host apply path (reference main.cpp:496-499):
// per distinct sample context, skip when the ref_k context is a known
// reference context (context_bf bit set), else add the sample count to
// the alt-BF's rank-compressed counter of the centered canonical k-mer.
// The numpy path did this as two latency-bound fancy-index gathers into
// GiB-scale word/rank arrays plus mask allocations (~1.5 M rows/s,
// single thread, the dominant cost of the weights phase at WGS scale);
// here each row stays in registers and rows run in parallel.  Counter
// updates use an atomic add — u32 wrap is commutative, so the result is
// bit-identical to any sequential order (counters are read mod 2^16).
void malva_bf_apply_hashed(const uint64_t* ctx_hash, const uint64_t* cen_hash,
                           const uint32_t* cnts, int64_t n,
                           uint64_t ctx_size, const uint32_t* ctx_words,
                           uint64_t bf_size, const uint32_t* bf_words,
                           const uint32_t* bf_rank, uint32_t* bf_counts) {
#pragma omp parallel for schedule(static) if (n > 4096)
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t ci = ctx_hash[i] % ctx_size;
    if ((ctx_words[ci >> 5] >> (ci & 31)) & 1u) continue;
    const uint64_t bi = cen_hash[i] % bf_size;
    const uint32_t wv = bf_words[bi >> 5];
    const uint32_t b = (uint32_t)(bi & 31);
    if (!((wv >> b) & 1u)) continue;
    const uint64_t cidx =
        (uint64_t)bf_rank[bi >> 5] + __builtin_popcount(wv & ((1u << b) - 1u));
#pragma omp atomic
    bf_counts[cidx] += cnts[i];
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Variant-block signature-extraction engine (the full extract_kmers of
// malva_tpu_torch/variants/blocks.py, i.e. reference var_block.hpp:95-219 +
// :436-786, over a GROUP of blocks in one call, OpenMP-parallel across
// units of work, a unit for each kChunk variants of a block).  Semantics mirror
// blocks.py exactly; ORDER of signatures within an allele bucket is
// unspecified (the downstream coverage is a max over signatures), but the
// k-mer order WITHIN a signature is fixed (the integer incremental mean
// is order-dependent).
//
// Per-group flat inputs (see utils/native.py extract_columns):
//   blk_off[n_blocks+1]      variant index ranges per block
//   ref_ptrs/ref_lens        per-block contig bytes
//   pos/vsize/vmin/present   per-variant (global index)
//   al_start[n_vars+1]       variant v's alleles are al_off slots
//                            [al_start[v], al_start[v+1]]; allele 0 = REF
//   al_off[total_alleles+1]  byte offsets into al_bytes
//   gt1/gt2/ph ptrs          per-variant int32*/int32*/uint8* (0 if absent)
// Flat outputs, grouped per (variant, allele_index) target:
//   tgt_var/tgt_allele/tgt_nsig, sig_nk (k-mers per signature),
//   kmer_len + bytes (concatenated k-mer strings), the units' outputs in
//   block order, then chunk order.
// malva_extract_group returns a handle that holds them; out_counts[0..3]
// = their sizes, for the caller to allocate exactly and pass to
// malva_extract_take, which copies them out and frees the handle
// (malva_extract_free frees it unread).  out_counts[4] = first variant
// with an out-of-range GT allele index (clamped to REF), or -1;
// out_counts[5..8] = the blocks extracted, the sum of the units' seconds
// on the threads that ran them, the longest block's wall (its first
// unit's start to its last unit's end, with its serial set-up: the
// call's critical path), in microseconds, and the units run.

#include <chrono>
#include <string>
#include <unordered_set>

namespace {

struct BlockOut {
  std::string bytes;
  std::vector<int32_t> kmer_len;
  std::vector<int32_t> sig_nk;
  std::vector<int32_t> tgt_var, tgt_allele, tgt_nsig;
  int64_t oob_var = -1;
};

struct StrView {
  const uint8_t* p;
  int64_t n;
};

// Open-addressing row-dedup: rows live contiguously in the destination
// vector; the table stores row indices and compares in place — no
// per-row std::string allocation (the dominant cost of cohort-scale
// profile projections before this).
class RowDedup {
 public:
  void reset(int64_t width, int64_t expect) {
    width_ = width;
    size_t cap = 16;
    while (cap < (size_t)(expect > 0 ? expect : 1) * 2) cap <<= 1;
    mask_ = cap - 1;
    slots_.assign(cap, -1);
  }
  bool insert(std::vector<int32_t>& dst, const int32_t* row) {
    uint64_t h = xxh3_one((const uint8_t*)row, width_ * 4);
    size_t i = (size_t)h & mask_;
    while (true) {
      int64_t s = slots_[i];
      if (s < 0) {
        slots_[i] = (int64_t)(dst.size() / (size_t)width_);
        dst.insert(dst.end(), row, row + width_);
        return true;
      }
      if (!std::memcmp(dst.data() + s * width_, row, (size_t)width_ * 4))
        return false;
      i = (i + 1) & mask_;
    }
  }

 private:
  int64_t width_ = 0;
  size_t mask_ = 0;
  std::vector<int64_t> slots_;
};

// append a length-prefixed element to a dedup key
inline void key_append(std::string& key, const uint8_t* p, int64_t n) {
  uint32_t len32 = (uint32_t)n;
  key.append((const char*)&len32, 4);
  key.append((const char*)p, (size_t)n);
}

// Two-level window dedup (mirrors blocks.py extract_kmers CHUNK=64): the
// genomes' rows are projected once per kChunk consecutive variants onto
// the union of their combinations' columns, then per variant from that
// much smaller matrix — without this, cohort-scale blocks (30k samples,
// thousands of near variants) pay a full scan of the genomes per variant.
// A chunk reads only its block's shared, read-only state and writes only
// its own variants' outputs, so each chunk is a unit of work of its own.
constexpr int64_t kChunk = 64;

// A block's variants and the column of each present variant with GT
// values among them (-1 for the others): built once a block and read by
// every unit that extracts it.
struct BlockVars {
  int64_t v0 = 0;
  std::vector<V> vs;
  std::vector<int64_t> col_of;
  int64_t ncols = 0;

  void build(const int64_t* pos, const int64_t* vsize, const int64_t* vmin,
             const uint8_t* present, const uint64_t* gt1, int64_t b0,
             int64_t b1, int64_t n_ind) {
    v0 = b0;
    int64_t n = b1 - b0;
    vs.resize(n);
    col_of.assign(n, -1);
    ncols = 0;
    for (int64_t i = 0; i < n; ++i) {
      vs[i] = V{pos[b0 + i], vsize[b0 + i], vmin[b0 + i], present[b0 + i]};
      if (vs[i].present && n_ind > 0 && gt1[b0 + i]) col_of[i] = ncols++;
    }
  }
};

class BlockExtractor {
 public:
  BlockExtractor(const BlockVars& bv, const int64_t* al_start,
                 const int64_t* al_off, const uint8_t* al_bytes,
                 const uint64_t* gt1, const uint64_t* gt2, const uint64_t* ph,
                 const uint8_t* ref, int64_t ref_len, int64_t n_ind,
                 int64_t k, bool haploid, BlockOut& out)
      : al_start_(al_start), al_off_(al_off), al_bytes_(al_bytes),
        gt1_(gt1), gt2_(gt2), ph_(ph), v0_(bv.v0), ref_(ref),
        ref_len_(ref_len), n_ind_(n_ind), k_(k), haploid_(haploid),
        out_(out), vs_(bv.vs), col_of_(bv.col_of) {
    stride_ = haploid_ ? 1 : 3;
    ncols_ = bv.ncols;
  }

  // The kChunk variants from `base`, from the genomes' rows over their
  // window's GT columns, deduplicated in genome order.  That is the rows,
  // in the order, that projecting the block's deduplicated profiles would
  // give: the first genome with a projected row is also the first with
  // its whole profile.
  void run_chunk(int64_t base) {
    int64_t hi = std::min((int64_t)vs_.size(), base + kChunk);
    std::vector<int64_t> members;
    std::vector<std::vector<std::vector<int32_t>>> combs_of;
    for (int64_t i = base; i < hi; ++i) {
      const V& v = vs_[i];
      if (!v.present || v.pos < k_ || v.pos > ref_len_ - k_) continue;
      members.push_back(i);
      combs_of.emplace_back();
      build_combs(i, combs_of.back());
    }
    if (members.empty()) return;
    std::vector<int64_t> cwin;
    int64_t lo = window_of(combs_of.data(), combs_of.size(), cwin);
    project_gt(cwin, cmat_);
    std::vector<int64_t> cpos(cwin.back() - lo + 1, -1);
    for (size_t w = 0; w < cwin.size(); ++w) cpos[cwin[w] - lo] = (int64_t)w;
    int64_t cmat_width = (int64_t)cwin.size() * stride_;
    for (size_t m = 0; m < members.size(); ++m)
      extract_variant(members[m], combs_of[m], cmat_, cmat_width, cpos.data(),
                      lo);
  }

 private:
  // The sorted union of the combinations' members into `window`; returns
  // its first.  Marks only the span the members cover, not the block.
  int64_t window_of(const std::vector<std::vector<int32_t>>* combs,
                    size_t n_lists, std::vector<int64_t>& window) {
    int64_t lo = INT64_MAX, top = -1;
    for (size_t l = 0; l < n_lists; ++l)
      for (const auto& c : combs[l])
        for (int32_t j : c) {
          lo = std::min<int64_t>(lo, j);
          top = std::max<int64_t>(top, j);
        }
    in_.assign(top - lo + 1, 0);
    for (size_t l = 0; l < n_lists; ++l)
      for (const auto& c : combs[l])
        for (int32_t j : c) in_[j - lo] = 1;
    window.clear();
    for (int64_t j = lo; j <= top; ++j)
      if (in_[j - lo]) window.push_back(j);
    return lo;
  }

  int64_t n_alleles(int64_t gv) const {
    return al_start_[gv + 1] - al_start_[gv];
  }
  StrView allele(int64_t gv, int64_t a) const {
    // blocks.py _allele / _get_allele: index > len(alts) clamps to REF
    if (a >= n_alleles(gv)) {
      if (out_.oob_var < 0) out_.oob_var = gv;
      a = 0;
    }
    int64_t s = al_off_[al_start_[gv] + a];
    int64_t e = al_off_[al_start_[gv] + a + 1];
    return StrView{al_bytes_ + s, e - s};
  }

  // project a matrix onto the given variant columns and deduplicate rows; cols are local variant indices, local variant j's
  // column in src is src_col[j - src_lo] (must be >= 0).  Output is
  // row-major with the same per-variant stride.
  void project_dedup(const std::vector<int32_t>& src, int64_t src_width,
                     const int64_t* src_col, int64_t src_lo,
                     const std::vector<int64_t>& want_local,
                     std::vector<int32_t>& dst) {
    dst.clear();
    int64_t w = (int64_t)want_local.size() * stride_;
    if (src_width == 0 || src.empty()) return;
    int64_t rows = (int64_t)src.size() / src_width;
    if (w == stride_) {  // single-variant projection: u64-key dedup
      int64_t c = src_col[want_local[0] - src_lo] * stride_;
      std::unordered_set<uint64_t> seen;
      seen.reserve(64);
      for (int64_t r = 0; r < rows; ++r) {
        const int32_t* base = src.data() + r * src_width + c;
        uint64_t key;
        if (stride_ == 1) {
          key = (uint64_t)(uint32_t)base[0];
        } else {
          key = ((uint64_t)(uint32_t)base[0] << 33) |
                ((uint64_t)(uint32_t)base[1] << 2) |
                (uint64_t)(base[2] ? 1 : 0);
        }
        if (seen.insert(key).second)
          dst.insert(dst.end(), base, base + stride_);
      }
      return;
    }
    std::vector<int64_t> take;
    take.reserve(w);
    for (int64_t j : want_local) {
      int64_t c = src_col[j - src_lo];
      for (int64_t s = 0; s < stride_; ++s) take.push_back(c * stride_ + s);
    }
    std::vector<int32_t> row(w);
    dedup_.reset(w, rows);
    for (int64_t r = 0; r < rows; ++r) {
      const int32_t* base = src.data() + r * src_width;
      for (int64_t j = 0; j < w; ++j) row[j] = base[take[j]];
      dedup_.insert(dst, row.data());
    }
  }

  // The genomes' rows over the given variant columns, deduplicated in
  // genome order (zeros for a variant without GT values).  Rows are
  // gathered a tile of genomes at a time, each GT column read in runs.
  void project_gt(const std::vector<int64_t>& want_local,
                  std::vector<int32_t>& dst) {
    dst.clear();
    if (ncols_ == 0 || n_ind_ == 0) return;
    const int64_t m = (int64_t)want_local.size(), w = m * stride_;
    if (m == 1 && col_of_[want_local[0]] >= 0) {
      // one column, the dominant window on sparse cohorts: allele indices
      // are tiny, so a 13-bit bitmap ((a1<64)<<7 | (a2<64)<<1 | phase)
      // replaces a row hash a genome; larger values go to a u64 set
      const int64_t gv = v0_ + want_local[0];
      const int32_t* a1 = (const int32_t*)gt1_[gv];
      const int32_t* a2 = (const int32_t*)gt2_[gv];
      const uint8_t* ph = (const uint8_t*)ph_[gv];
      uint64_t bm[128] = {0};
      std::unordered_set<uint64_t> seen;
      for (int64_t r = 0; r < n_ind_; ++r) {
        const int32_t x = a1[r], y = haploid_ ? 0 : a2[r];
        const int32_t p = haploid_ ? 0 : (ph[r] ? 1 : 0);
        bool fresh;
        if ((uint32_t)x < 64 && (uint32_t)y < 64) {
          const uint32_t key = ((uint32_t)x << 7) | ((uint32_t)y << 1) | (uint32_t)p;
          const uint64_t bit = 1ULL << (key & 63);
          fresh = !(bm[key >> 6] & bit);
          bm[key >> 6] |= bit;
        } else {
          fresh = seen.insert(((uint64_t)(uint32_t)x << 33) |
                              ((uint64_t)(uint32_t)y << 2) | (uint64_t)p).second;
        }
        if (!fresh) continue;
        dst.push_back(x);
        if (!haploid_) {
          dst.push_back(y);
          dst.push_back(p);
        }
      }
      return;
    }
    const int64_t kTile = 256;
    tile_.resize((size_t)(kTile * w));
    dedup_.reset(w, n_ind_);  // a slot for every genome's row
    for (int64_t r0 = 0; r0 < n_ind_; r0 += kTile) {
      const int64_t rn = std::min(kTile, n_ind_ - r0);
      for (int64_t c = 0; c < m; ++c) {
        const int64_t gv = v0_ + want_local[c];
        int32_t* out = tile_.data() + c * stride_;
        if (col_of_[want_local[c]] < 0) {  // no GT values: zeros
          for (int64_t t = 0; t < rn; ++t)
            std::fill(out + t * w, out + t * w + stride_, 0);
          continue;
        }
        const int32_t* a1 = (const int32_t*)gt1_[gv] + r0;
        if (haploid_) {
          for (int64_t t = 0; t < rn; ++t) out[t * w] = a1[t];
          continue;
        }
        const int32_t* a2 = (const int32_t*)gt2_[gv] + r0;
        const uint8_t* p = (const uint8_t*)ph_[gv] + r0;
        for (int64_t t = 0; t < rn; ++t) {
          out[t * w] = a1[t];
          out[t * w + 1] = a2[t];
          out[t * w + 2] = p[t] ? 1 : 0;
        }
      }
      for (int64_t t = 0; t < rn; ++t) dedup_.insert(dst, tile_.data() + t * w);
    }
  }

  void build_combs(int64_t i, std::vector<std::vector<int32_t>>& combs) {
    std::vector<std::vector<int32_t>> right, left;
    grow(vs_, i, k_, +1, right);
    grow(vs_, i, k_, -1, left);
    if (left.empty() && right.empty()) {
      combs.push_back({(int32_t)i});
    } else if (left.empty()) {
      for (const auto& rc : right) {
        std::vector<int32_t> c{(int32_t)i};
        c.insert(c.end(), rc.begin(), rc.end());
        combs.push_back(std::move(c));
      }
    } else {
      for (const auto& lc : left) {
        std::vector<int32_t> base(lc.rbegin(), lc.rend());
        base.push_back((int32_t)i);
        if (right.empty()) {
          combs.push_back(base);
        } else {
          for (const auto& rc : right) {
            std::vector<int32_t> c = base;
            c.insert(c.end(), rc.begin(), rc.end());
            combs.push_back(std::move(c));
          }
        }
      }
    }
  }

  void extract_variant(int64_t i,
                       const std::vector<std::vector<int32_t>>& combs,
                       const std::vector<int32_t>& src, int64_t src_width,
                       const int64_t* src_col, int64_t src_lo) {
    int64_t gv = v0_ + i;

    // window = sorted union of comb members; project the CHUNK matrix
    int64_t wlo = window_of(&combs, 1, window_);
    wpos_.assign(window_.back() - wlo + 1, -1);
    for (int64_t w = 0; w < (int64_t)window_.size(); ++w)
      wpos_[window_[w] - wlo] = w;
    wmat_.clear();
    project_dedup(src, src_width, src_col, src_lo, window_, wmat_);
    int64_t wmat_width = (int64_t)window_.size() * stride_;

    // temp per-variant signature store, grouped per allele at the end
    var_bytes_.clear();
    var_kmer_off_.clear();   // start offset of each kmer in var_bytes_
    var_kmer_len_.clear();
    var_sig_nk_.clear();
    var_sig_allele_.clear();

    for (const auto& comb : combs) {
      // the rendered-tuple dedup set is per comb (blocks.py builds a
      // fresh `aacs` set per _build_alleles_combs call)
      aac_seen_.clear();
      // ref gap strings between consecutive comb members
      gaps_.clear();
      for (size_t j = 1; j < comb.size(); ++j) {
        const V& prev = vs_[comb[j - 1]];
        const V& curr = vs_[comb[j]];
        gaps_.push_back({prev.pos + prev.size, curr.pos});
      }
      build_aacs(comb, wpos_.data(), wlo, wmat_width);
      for (const auto& aac : aacs_list_) render_aac(gv, i, comb, aac);
    }

    // group signatures per allele index in first-appearance order
    emit_variant(gv);
  }

  // enumerate sample-consistent allele-index combinations for `comb`
  // (blocks.py _build_alleles_combs), then render+dedup the allele byte
  // tuples.  aacs_list_ holds per-tuple vectors of allele indices.
  void build_aacs(const std::vector<int32_t>& comb, const int64_t* wpos,
                  int64_t wlo, int64_t wmat_width) {
    aacs_list_.clear();
    idx_seen_.clear();
    int64_t R = wmat_width ? (int64_t)wmat_.size() / wmat_width : 0;
    size_t m = comb.size();
    if (m == 1) {
      int64_t p = wpos[comb[0] - wlo];
      std::unordered_set<int32_t> vals;
      for (int64_t r = 0; r < R; ++r) {
        const int32_t* row = wmat_.data() + r * wmat_width;
        if (haploid_) {
          vals.insert(row[p]);
        } else {
          vals.insert(row[3 * p]);
          vals.insert(row[3 * p + 1]);
        }
      }
      for (int32_t a : vals) aacs_list_.push_back({a});
      return;
    }
    // project wmat onto comb columns + dedup
    std::vector<int64_t> comb_local(comb.begin(), comb.end());
    // build a direct col map: wpos gives the window group index
    sub_.clear();
    {
      std::vector<int32_t> row(m * stride_);
      dedup_.reset((int64_t)(m * stride_), R);
      for (int64_t r = 0; r < R; ++r) {
        const int32_t* base = wmat_.data() + r * wmat_width;
        for (size_t j = 0; j < m; ++j) {
          int64_t p = wpos[comb[j] - wlo];
          for (int64_t s = 0; s < stride_; ++s)
            row[j * stride_ + s] = base[p * stride_ + s];
        }
        dedup_.insert(sub_, row.data());
      }
    }
    int64_t rows = m ? (int64_t)sub_.size() / (m * stride_) : 0;
    // u64 tuple keys (8 bits per position, MSB-first) when the comb is
    // short and allele indices are byte-sized — the dense-unphased 2^m
    // expansion over cohort-scale unique-row counts is string-allocation
    // bound otherwise (measured 23x slower at 2,504 samples)
    bool small8 = m <= 8;
    for (size_t t = 0; t < sub_.size() && small8; ++t)
      if ((uint32_t)sub_[t] >= 256) small8 = false;
    idx64_.clear();
    auto emit64 = [&](uint64_t key) {
      if (idx64_.insert(key).second) {
        std::vector<int32_t> tv(m);
        for (size_t j = 0; j < m; ++j)
          tv[j] = (int32_t)((key >> (8 * (m - 1 - j))) & 255);
        aacs_list_.push_back(std::move(tv));
      }
    };
    auto add_idx = [&](const int32_t* vals, int64_t stride, int64_t off) {
      if (small8) {
        uint64_t key = 0;
        for (size_t j = 0; j < m; ++j)
          key = (key << 8) | (uint64_t)(uint32_t)vals[j * stride + off];
        emit64(key);
        return;
      }
      std::string key;
      key.reserve(m * 4);
      for (size_t j = 0; j < m; ++j)
        key.append((const char*)&vals[j * stride + off], 4);
      if (idx_seen_.insert(key).second) {
        std::vector<int32_t> t(m);
        for (size_t j = 0; j < m; ++j) t[j] = vals[j * stride + off];
        aacs_list_.push_back(std::move(t));
      }
    };
    if (haploid_) {
      for (int64_t r = 0; r < rows; ++r) add_idx(sub_.data() + r * m, 1, 0);
      return;
    }
    for (int64_t r = 0; r < rows; ++r) {
      const int32_t* row = sub_.data() + r * 3 * m;
      bool phased = true;
      for (size_t j = 0; j < m; ++j)
        if (row[3 * j + 2] == 0) { phased = false; break; }
      if (phased) {
        add_idx(row, 3, 0);  // a1 haplotype
        add_idx(row, 3, 1);  // a2 haplotype
      } else if (small8) {
        // all 2^m selections in u64 space, deduplicated level by level
        exp64_.clear();
        exp64_.push_back(0);
        for (size_t j = 0; j < m; ++j) {
          int32_t x = row[3 * j], y = row[3 * j + 1];
          next64_.clear();
          lvl64_.clear();
          for (uint64_t t : exp64_) {
            uint64_t e1 = (t << 8) | (uint64_t)(uint32_t)x;
            if (lvl64_.insert(e1).second) next64_.push_back(e1);
            if (x != y) {
              uint64_t e2 = (t << 8) | (uint64_t)(uint32_t)y;
              if (lvl64_.insert(e2).second) next64_.push_back(e2);
            }
          }
          exp64_.swap(next64_);
        }
        for (uint64_t t : exp64_) emit64(t);
      } else {
        // all 2^m selections, deduplicated level by level
        expand_.clear();
        expand_.push_back(std::string());
        for (size_t j = 0; j < m; ++j) {
          int32_t x = row[3 * j], y = row[3 * j + 1];
          next_.clear();
          lvl_seen_.clear();
          for (const std::string& t : expand_) {
            if (x == y) {
              std::string e = t;
              e.append((const char*)&x, 4);
              if (lvl_seen_.insert(e).second) next_.push_back(std::move(e));
            } else {
              for (int32_t a : {x, y}) {
                std::string e = t;
                e.append((const char*)&a, 4);
                if (lvl_seen_.insert(e).second) next_.push_back(std::move(e));
              }
            }
          }
          expand_.swap(next_);
        }
        for (const std::string& t : expand_) {
          if (idx_seen_.insert(t).second) {
            std::vector<int32_t> tv(m);
            std::memcpy(tv.data(), t.data(), m * 4);
            aacs_list_.push_back(std::move(tv));
          }
        }
      }
    }
  }

  // render one allele-index tuple: dedup the rendered allele byte tuple,
  // then assemble the signature k-mer string(s) (blocks.py _render_comb)
  void render_aac(int64_t gv, int64_t i, const std::vector<int32_t>& comb,
                  const std::vector<int32_t>& idx_tuple) {
    size_t m = comb.size();
    aac_views_.clear();
    aac_key_.clear();
    for (size_t j = 0; j < m; ++j) {
      StrView sv = allele(v0_ + comb[j], idx_tuple[j]);
      aac_views_.push_back(sv);
      key_append(aac_key_, sv.p, sv.n);
    }
    if (!aac_seen_.insert(aac_key_).second) return;  // rendered-tuple dedup

    // long-allele case: single allele >= k -> all its k-windows, one sig
    if (m == 1 && aac_views_[0].n >= k_) {
      const StrView& mid = aac_views_[0];
      int64_t nwin = mid.n - k_ + 1;
      for (int64_t p = 0; p < nwin; ++p) push_kmer(mid.p + p, k_);
      finish_sig(gv, nwin, mid);
      return;
    }

    kmer_buf_.clear();
    int64_t mid_pos_in_kmer = 0;
    StrView mid{nullptr, 0};
    for (size_t j = 0; j < m; ++j) {
      if (comb[j] == (int32_t)i) {
        mid_pos_in_kmer = (int64_t)kmer_buf_.size();
        mid = aac_views_[j];
      }
      kmer_buf_.append((const char*)aac_views_[j].p, (size_t)aac_views_[j].n);
      if (j < gaps_.size()) {
        int64_t gs = gaps_[j].first, ge = gaps_[j].second;
        if (gs < 0) gs = 0;
        if (ge > ref_len_) ge = ref_len_;
        if (ge > gs) kmer_buf_.append((const char*)(ref_ + gs), (size_t)(ge - gs));
      }
    }
    int64_t first_part = mid_pos_in_kmer + mid.n / 2;
    int64_t second_part = (int64_t)kmer_buf_.size() - first_part;
    int64_t missing_prefix = k_ / 2 - first_part;
    int64_t missing_suffix = (k_ + 1) / 2 - second_part;

    if (missing_prefix >= 0) {
      const V& first_var = vs_[comb[0]];
      int64_t start = first_var.pos - missing_prefix;
      if (start < 0) start = 0;  // upstream would throw (UB edge)
      int64_t stop = first_var.pos;
      if (stop > ref_len_) stop = ref_len_;
      if (stop > start)
        kmer_buf_.insert(0, (const char*)(ref_ + start), (size_t)(stop - start));
    } else {
      kmer_buf_.erase(0, (size_t)(-missing_prefix));
    }
    if (missing_suffix >= 0) {
      const V& last_var = vs_[comb.back()];
      int64_t p = last_var.pos + last_var.size;
      int64_t stop = p + missing_suffix;
      if (p < 0) p = 0;
      if (stop > ref_len_) stop = ref_len_;
      if (stop > p) kmer_buf_.append((const char*)(ref_ + p), (size_t)(stop - p));
    } else {
      kmer_buf_.resize(kmer_buf_.size() + missing_suffix);
    }
    push_kmer((const uint8_t*)kmer_buf_.data(), (int64_t)kmer_buf_.size());
    finish_sig(gv, 1, mid);
  }

  void push_kmer(const uint8_t* p, int64_t n) {
    var_kmer_off_.push_back((int64_t)var_bytes_.size());
    var_kmer_len_.push_back((int32_t)n);
    var_bytes_.append((const char*)p, (size_t)n);
  }

  void finish_sig(int64_t gv, int64_t nk, const StrView& mid_allele) {
    // allele index of the mid allele (variant.get_allele_index: REF then
    // ALTs in order, first byte-equal match; -1 when absent)
    int32_t idx = -1;
    int64_t na = n_alleles(gv);
    for (int64_t a = 0; a < na; ++a) {
      int64_t s = al_off_[al_start_[gv] + a];
      int64_t e = al_off_[al_start_[gv] + a + 1];
      if (e - s == mid_allele.n &&
          std::memcmp(al_bytes_ + s, mid_allele.p, (size_t)mid_allele.n) == 0) {
        idx = (int32_t)a;
        break;
      }
    }
    var_sig_nk_.push_back((int32_t)nk);
    var_sig_allele_.push_back(idx);
  }

  void emit_variant(int64_t gv) {
    if (var_sig_nk_.empty()) return;
    // allele buckets in first-appearance order
    std::vector<int32_t> order;
    for (int32_t a : var_sig_allele_) {
      bool found = false;
      for (int32_t b : order)
        if (b == a) { found = true; break; }
      if (!found) order.push_back(a);
    }
    int64_t kmer_at = 0;
    std::vector<int64_t> sig_kmer_start(var_sig_nk_.size());
    for (size_t s = 0; s < var_sig_nk_.size(); ++s) {
      sig_kmer_start[s] = kmer_at;
      kmer_at += var_sig_nk_[s];
    }
    for (int32_t a : order) {
      int32_t nsig = 0;
      for (size_t s = 0; s < var_sig_nk_.size(); ++s) {
        if (var_sig_allele_[s] != a) continue;
        ++nsig;
        out_.sig_nk.push_back(var_sig_nk_[s]);
        for (int64_t q = 0; q < var_sig_nk_[s]; ++q) {
          int64_t ki = sig_kmer_start[s] + q;
          int64_t off = var_kmer_off_[ki];
          int32_t len = var_kmer_len_[ki];
          out_.kmer_len.push_back(len);
          out_.bytes.append(var_bytes_, (size_t)off, (size_t)len);
        }
      }
      out_.tgt_var.push_back((int32_t)gv);
      out_.tgt_allele.push_back(a);
      out_.tgt_nsig.push_back(nsig);
    }
  }

  const int64_t *al_start_, *al_off_;
  const uint8_t* al_bytes_;
  const uint64_t *gt1_, *gt2_, *ph_;
  int64_t v0_;
  const uint8_t* ref_;
  int64_t ref_len_, n_ind_, k_;
  bool haploid_;
  BlockOut& out_;

  const std::vector<V>& vs_;
  const std::vector<int64_t>& col_of_;
  int64_t stride_ = 3, ncols_ = 0;
  std::vector<int32_t> cmat_, wmat_, sub_, tile_;
  std::vector<int64_t> window_, wpos_;
  std::vector<char> in_;
  std::vector<std::pair<int64_t, int64_t>> gaps_;
  std::vector<std::vector<int32_t>> aacs_list_;
  RowDedup dedup_;
  std::unordered_set<std::string> idx_seen_, aac_seen_, lvl_seen_;
  std::unordered_set<uint64_t> idx64_, lvl64_;
  std::vector<uint64_t> exp64_, next64_;
  std::vector<std::string> expand_, next_;
  std::vector<StrView> aac_views_;
  std::string aac_key_, kmer_buf_, var_bytes_;
  std::vector<int64_t> var_kmer_off_;
  std::vector<int32_t> var_kmer_len_, var_sig_nk_, var_sig_allele_;
};

// The extraction's outputs, unit after unit, until the caller copies them.
struct ExtractResult {
  std::vector<BlockOut> outs;
};

}  // namespace

extern "C" {

void* malva_extract_group(
    int64_t n_blocks, const int64_t* blk_off, const uint64_t* ref_ptrs,
    const int64_t* ref_lens, const int64_t* pos, const int64_t* vsize,
    const int64_t* vmin, const uint8_t* present, const int64_t* al_start,
    const int64_t* al_off, const uint8_t* al_bytes, const uint64_t* gt1_ptrs,
    const uint64_t* gt2_ptrs, const uint64_t* ph_ptrs, int64_t n_ind,
    int64_t k, int haploid, int64_t* out_counts) {
  using Clock = std::chrono::steady_clock;
  auto ns_since = [](Clock::time_point t) {
    return (int64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
               Clock::now() - t).count();
  };
  // units: (block, first variant of its chunk); each block's variants
  // are gathered here, once, for its units to share
  std::vector<std::pair<int64_t, int64_t>> units;
  std::vector<BlockVars> blocks(n_blocks);
  std::vector<int64_t> prep_ns(n_blocks, 0);
  const Clock::time_point t0 = Clock::now();
  for (int64_t b = 0; b < n_blocks; ++b) {
    const Clock::time_point tb = Clock::now();
    blocks[b].build(pos, vsize, vmin, present, gt1_ptrs, blk_off[b],
                    blk_off[b + 1], n_ind);
    prep_ns[b] = ns_since(tb);
    for (int64_t base = 0; base < blk_off[b + 1] - blk_off[b]; base += kChunk)
      units.emplace_back(b, base);
  }
  const int64_t n_units = (int64_t)units.size();
  auto* res = new ExtractResult;
  res->outs.resize(n_units);
  std::vector<int64_t> u_start(n_units), u_end(n_units);
#pragma omp parallel for schedule(dynamic)
  for (int64_t u = 0; u < n_units; ++u) {
    u_start[u] = ns_since(t0);
    const int64_t b = units[u].first;
    BlockExtractor(blocks[b], al_start, al_off, al_bytes, gt1_ptrs, gt2_ptrs,
                   ph_ptrs, (const uint8_t*)ref_ptrs[b], ref_lens[b], n_ind, k,
                   haploid != 0, res->outs[u]).run_chunk(units[u].second);
    u_end[u] = ns_since(t0);
  }
  // a block's wall: its set-up, then its first unit's start to its last
  // unit's end; its out-of-range variant: its first unit's with one
  std::vector<int64_t> first(n_blocks, INT64_MAX), last(n_blocks, 0);
  std::vector<int64_t> blk_oob(n_blocks, -1);
  int64_t busy_ns = 0;
  for (int64_t b = 0; b < n_blocks; ++b) busy_ns += prep_ns[b];
  int64_t n_tgt = 0, n_sig = 0, n_kmer = 0, n_bytes = 0;
  for (int64_t u = 0; u < n_units; ++u) {
    const int64_t b = units[u].first;
    const BlockOut& o = res->outs[u];
    busy_ns += u_end[u] - u_start[u];
    first[b] = std::min(first[b], u_start[u]);
    last[b] = std::max(last[b], u_end[u]);
    if (blk_oob[b] < 0) blk_oob[b] = o.oob_var;
    n_tgt += (int64_t)o.tgt_var.size();
    n_sig += (int64_t)o.sig_nk.size();
    n_kmer += (int64_t)o.kmer_len.size();
    n_bytes += (int64_t)o.bytes.size();
  }
  int64_t critical_ns = 0, oob = -1;
  for (int64_t b = 0; b < n_blocks; ++b) {
    critical_ns = std::max(critical_ns, prep_ns[b] + last[b] - first[b]);
    if (blk_oob[b] >= 0 && (oob < 0 || blk_oob[b] < oob)) oob = blk_oob[b];
  }
  out_counts[0] = n_tgt;
  out_counts[1] = n_sig;
  out_counts[2] = n_kmer;
  out_counts[3] = n_bytes;
  out_counts[4] = oob;
  out_counts[5] = n_blocks;
  out_counts[6] = busy_ns / 1000;
  out_counts[7] = critical_ns / 1000;
  out_counts[8] = n_units;
  return res;
}

// Copies malva_extract_group's outputs into buffers of the sizes it
// reported, in unit order, and frees its handle.
void malva_extract_take(void* handle, int32_t* out_tgt_var,
                        int32_t* out_tgt_allele, int32_t* out_tgt_nsig,
                        int32_t* out_sig_nk, int32_t* out_kmer_len,
                        uint8_t* out_bytes) {
  auto* res = (ExtractResult*)handle;
  int64_t t = 0, s = 0, km = 0, by = 0;
  for (const auto& o : res->outs) {
    std::memcpy(out_tgt_var + t, o.tgt_var.data(), o.tgt_var.size() * 4);
    std::memcpy(out_tgt_allele + t, o.tgt_allele.data(), o.tgt_allele.size() * 4);
    std::memcpy(out_tgt_nsig + t, o.tgt_nsig.data(), o.tgt_nsig.size() * 4);
    t += (int64_t)o.tgt_var.size();
    std::memcpy(out_sig_nk + s, o.sig_nk.data(), o.sig_nk.size() * 4);
    s += (int64_t)o.sig_nk.size();
    std::memcpy(out_kmer_len + km, o.kmer_len.data(), o.kmer_len.size() * 4);
    km += (int64_t)o.kmer_len.size();
    std::memcpy(out_bytes + by, o.bytes.data(), o.bytes.size());
    by += (int64_t)o.bytes.size();
  }
  delete res;
}

void malva_extract_free(void* handle) { delete (ExtractResult*)handle; }

}  // extern "C"

// Batched GT parse + fused htslib decode over many records (OpenMP
// across records).  Mirrors Variant._extract_genotypes
// (malva_tpu_torch/variants/variant.py) composed with malva_parse_gt:
//   a1 = max((first >> 1) - 1, 0)
//   a2 = a1 where slot 1 is VECTOR_END (or, ploidy-1 records, where the
//        NEXT sample's first entry is the wrap-around read upstream
//        performs — defined here over the FULL sample set, so callers
//        with a sample subset must use the per-record path), else
//        max((second >> 1) - 1, 0)
//   phase = true at VECTOR_END, else slot 1's phase bit
// Inputs: each record's sample region and gt_at.  Outputs: (n_rec,
// n_samples) int32 a1/a2 + uint8 phase, ok[r] = 1, or 0 when that
// record needs the Python path (malformed / ploidy > 64).
namespace {

// One record of the batched parse: its decoded row into ra1/ra2/rp
// (n_samples each), or false when the record needs the Python path.
bool gt_row(const uint8_t* s, int64_t len, int64_t gt_at, int64_t n_samples,
            std::vector<int32_t>& enc, int32_t* ra1, int32_t* ra2, uint8_t* rp) {
  const int32_t kVectorEnd = (int32_t)0x80000000;
  // fixed-width fast paths (GT first in FORMAT, single-digit alleles):
  // "a|b\t"*n — the overwhelmingly common cohort layout — and haploid
  // "a\t"*n.  Byte-for-byte the same decode as the generic path below.
  if (gt_at == 0 && len == 4 * n_samples - 1) {
    bool good = true;
    for (int64_t i = 0; i < n_samples && good; ++i) {
      const uint8_t* p = s + 4 * i;
      uint8_t d1 = p[0], sep = p[1], d2 = p[2];
      good = ((d1 >= '0' && d1 <= '9') || d1 == '.') &&
             (sep == '|' || sep == '/') &&
             ((d2 >= '0' && d2 <= '9') || d2 == '.') &&
             (i + 1 == n_samples || p[3] == '\t');
    }
    if (good) {
      for (int64_t i = 0; i < n_samples; ++i) {
        const uint8_t* p = s + 4 * i;
        int32_t e1 = p[0] == '.' ? 0 : (int32_t)(p[0] - '0' + 1) << 1;
        int32_t e2 = (p[2] == '.' ? 0 : (int32_t)(p[2] - '0' + 1) << 1) |
                     (p[1] == '|');
        int32_t v1 = (e1 >> 1) - 1;
        ra1[i] = v1 > 0 ? v1 : 0;
        int32_t v2 = (e2 >> 1) - 1;
        ra2[i] = v2 > 0 ? v2 : 0;
        rp[i] = (uint8_t)(e2 & 1);
      }
      return true;
    }
  }
  if (gt_at == 0 && len == 2 * n_samples - 1) {
    bool good = true;
    for (int64_t i = 0; i < n_samples && good; ++i) {
      uint8_t d = s[2 * i];
      good = ((d >= '0' && d <= '9') || d == '.') &&
             (i + 1 == n_samples || s[2 * i + 1] == '\t');
    }
    if (good) {  // ploidy 1: slot base+1 reads the NEXT sample's entry
      for (int64_t i = 0; i < n_samples; ++i) {
        uint8_t d = s[2 * i];
        int32_t e1 = d == '.' ? 0 : (int32_t)(d - '0' + 1) << 1;
        int32_t v1 = (e1 >> 1) - 1;
        ra1[i] = v1 > 0 ? v1 : 0;
        if (i + 1 < n_samples) {
          uint8_t dn = s[2 * (i + 1)];
          int32_t e2 = dn == '.' ? 0 : (int32_t)(dn - '0' + 1) << 1;
          int32_t v2 = (e2 >> 1) - 1;
          ra2[i] = v2 > 0 ? v2 : 0;
          rp[i] = 0;  // next sample's first entry: phase bit 0
        } else {
          ra2[i] = ra1[i];  // VECTOR_END
          rp[i] = 1;
        }
      }
      return true;
    }
  }
  for (int64_t cap = 8; cap <= 64; cap <<= 3) {  // -1 can be ploidy overflow
    enc.resize((size_t)(n_samples * cap));
    int64_t mp = malva_parse_gt(s, len, n_samples, gt_at, enc.data(), cap);
    if (mp < 0) continue;
    if (mp == 0) return false;  // no samples: Python path decides
    for (int64_t i = 0; i < n_samples; ++i) {
      int32_t first = enc[i * cap];
      int32_t second;
      if (mp >= 2) {
        second = enc[i * cap + 1];
      } else {
        // upstream reads slot base+1 = next sample's first entry; the
        // final sample's read is out of bounds there, defined as
        // VECTOR_END here (variant.py:104-108)
        second = (i + 1 < n_samples) ? enc[(i + 1) * cap] : kVectorEnd;
      }
      int32_t v1 = (first >> 1) - 1;
      ra1[i] = v1 > 0 ? v1 : 0;
      if (second == kVectorEnd) {
        ra2[i] = ra1[i];
        rp[i] = 1;
      } else {
        int32_t v2 = (second >> 1) - 1;
        ra2[i] = v2 > 0 ? v2 : 0;
        rp[i] = (uint8_t)(second & 1);
      }
    }
    return true;
  }
  return false;
}

}  // namespace

extern "C" {

// The batched GT parse of every record source (pipeline._gt_rows), over
// regions that lie anywhere in one buffer (the record scanner's text,
// below, or the Python path's records joined): record r's region is
// base[off[r], off[r] + len[r]).
void malva_parse_gt_spans(const uint8_t* base, const int64_t* off, const int64_t* len,
                          const int64_t* gt_at, int64_t n_rec, int64_t n_samples,
                          int32_t* a1, int32_t* a2, uint8_t* ph, uint8_t* ok) {
#pragma omp parallel
  {
    std::vector<int32_t> enc;
#pragma omp for schedule(dynamic, 16)
    for (int64_t r = 0; r < n_rec; ++r)
      ok[r] = gt_row(base + off[r], len[r], gt_at[r], n_samples, enc, a1 + r * n_samples,
                     a2 + r * n_samples, ph + r * n_samples);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// The VCF record scan of pass 2 and of the index's variant pass: one call
// inflates the text, splits its records, parses their fixed columns and
// groups the variants into blocks, up to one extraction batch, with the
// GIL released and no Python object made on the way.  It mirrors
// malva_tpu_torch/io/vcf.py VcfReader (the lines, the columns),
// variants/variant.py Variant (the alleles, sizes, frequencies and flags)
// and pipeline.py _iter_blocks (the block boundaries, the contig each
// block's reference comes from and used_out's state machine, its quirk
// included) exactly.
//
// What it leaves to Python: a record with a non-ASCII byte in a fixed
// column, a POS, QUAL or frequency outside the plain decimal grammar, or
// too few columns.  The scan hands such a record's line over (status 1);
// Python parses it, raising the InputError the Python path raises, or
// gives back what the grouping needs (malva_vcf_put), and the batch that
// holds it goes whole to the Python path (``fallback``).  A batch's GT
// regions and lines are offsets into the scanner's text, which stays in
// place until the next malva_vcf_scan call.

#if defined(MALVA_ZLIB)
#include <zlib.h>
#endif
#include <cstdio>
#include <cstdlib>
#include <string>
#include <unordered_map>

namespace {

// One batch as malva_vcf_scan leaves it (the layout of native.py's
// _ScanView).  The arrays are the scanner's own, valid until its next call.
struct ScanView {
  int64_t status;  // 0: a batch (n_vars 0 at the end), 1: a line for Python, 2: stream error
  int64_t n_vars, n_blocks, n_lines, n_used, n_names, fallback;
  int64_t rec_off, rec_len;  // status 1: the line, in buf
  const uint8_t* buf;
  const int64_t *line_off, *line_len, *gt_off, *gt_len, *gt_at;
  const int64_t *pos, *ref_size, *min_size, *max_size;
  const uint8_t* present;
  const float* qual;
  const int32_t* name;
  const int64_t *al_start, *al_off;
  const uint8_t* al_bytes;
  const float* freq;
  const int64_t* id_off;
  const uint8_t* id_bytes;
  const int64_t* blk_off;
  const int32_t* blk_name;
  const int32_t* used;
  const int64_t* name_off;
  const uint8_t* name_bytes;
};

// One record's parse; its line and GT region are offsets into the text.
struct Parsed {
  int64_t line_off = 0, line_len = 0, gt_off = 0, gt_len = 0, gt_at = -1;
  int64_t pos = 0, ref_size = 0, min_size = 0, max_size = 0, thresh = 0;
  int32_t name = 0;
  bool present = true, passing = false, from_py = false;
  float qual = 0;
  std::string alleles, id;
  std::vector<int64_t> al_len;
  std::vector<float> freqs;
};

inline bool is_digit(uint8_t c) { return c >= '0' && c <= '9'; }

// POS as Python's int() reads its plain form, [+-]?[0-9]{1,18}; false for
// anything else, which Python decides (a value or its InputError).
bool parse_int(const uint8_t* s, int64_t n, int64_t* out) {
  int64_t i = 0;
  bool neg = false;
  if (i < n && (s[i] == '+' || s[i] == '-')) neg = s[i++] == '-';
  if (i == n || n - i > 18) return false;
  int64_t v = 0;
  for (; i < n; ++i) {
    if (!is_digit(s[i])) return false;
    v = v * 10 + (s[i] - '0');
  }
  *out = neg ? -v : v;
  return true;
}

inline bool word_is(const uint8_t* s, int64_t n, const char* w) {
  if (n != (int64_t)std::strlen(w)) return false;
  for (int64_t i = 0; i < n; ++i)
    if ((s[i] | 0x20) != w[i]) return false;
  return true;
}

// A number as np.float32(token) reads it: Python's float(), correctly
// rounded to double, then a cast; so strtod and a cast, never strtof.
// 0: *out holds it; 1: Python's float() refuses the token; 2: the token
// has whitespace, '_' or a byte outside printable ASCII, where Python's
// grammar is wider than this one (Python decides).
int parse_float(const uint8_t* s, int64_t n, double* out) {
  for (int64_t i = 0; i < n; ++i)
    if (s[i] <= 0x20 || s[i] >= 0x7f || s[i] == '_') return 2;
  int64_t i = 0;
  if (i < n && (s[i] == '+' || s[i] == '-')) ++i;
  int64_t d0 = i;
  while (i < n && is_digit(s[i])) ++i;
  int64_t nd = i - d0;
  if (i < n && s[i] == '.') {
    int64_t f0 = ++i;
    while (i < n && is_digit(s[i])) ++i;
    nd += i - f0;
  }
  bool plain = nd > 0;
  if (plain && i < n && (s[i] == 'e' || s[i] == 'E')) {
    ++i;
    if (i < n && (s[i] == '+' || s[i] == '-')) ++i;
    int64_t e0 = i;
    while (i < n && is_digit(s[i])) ++i;
    plain = i > e0;
  }
  if (plain && i == n) {
    char tmp[64];
    if (n >= (int64_t)sizeof(tmp)) return 2;
    std::memcpy(tmp, s, (size_t)n);
    tmp[n] = 0;
    *out = std::strtod(tmp, nullptr);
    return 0;
  }
  double sign = 1.0;
  if (n > 0 && (s[0] == '+' || s[0] == '-')) {
    sign = s[0] == '-' ? -1.0 : 1.0;
    ++s;
    --n;
  }
  if (word_is(s, n, "inf") || word_is(s, n, "infinity")) {
    *out = sign * HUGE_VAL;
    return 0;
  }
  if (word_is(s, n, "nan")) {
    *out = std::nan("");
    return 0;
  }
  return 1;
}

// str.find over bytes, the empty needle included.
int64_t find(const uint8_t* h, int64_t n, const std::string& k, int64_t from) {
  int64_t m = (int64_t)k.size();
  if (from > n) return -1;
  if (m == 0) return from;
  for (int64_t i = from; i + m <= n; ++i)
    if (h[i] == (uint8_t)k[0] && std::memcmp(h + i, k.data(), (size_t)m) == 0) return i;
  return -1;
}

inline char upper(uint8_t c) { return (char)((c >= 'a' && c <= 'z') ? c - 32 : c); }

class VcfScan {
 public:
  VcfScan(FILE* f, bool gz, int64_t n_samples, std::string key, bool uniform, bool strip_chr,
          bool keep_absent, int64_t k)
      : f_(f), gz_(gz), n_samples_(n_samples), key_(std::move(key)), uniform_(uniform),
        strip_chr_(strip_chr), keep_absent_(keep_absent), half_k_((k + 1) / 2) {
#if defined(MALVA_ZLIB)
    if (gz_) {
      std::memset(&zs_, 0, sizeof(zs_));
      zinit_ = inflateInit2(&zs_, 16 + MAX_WBITS) == Z_OK;
      in_.resize(1 << 20);
    }
#endif
    name_off_.push_back(0);
  }
  ~VcfScan() {
#if defined(MALVA_ZLIB)
    if (zinit_) inflateEnd(&zs_);
#endif
    std::fclose(f_);
  }

  // Past the header: every line up to the one that starts with #CHROM.
  bool open() {
#if defined(MALVA_ZLIB)
    if (gz_ && !zinit_) return false;
#else
    if (gz_) return false;
#endif
    int64_t s, n;
    while (next_line(&s, &n))
      if (n >= 6 && std::memcmp(buf_.data() + s, "#CHROM", 6) == 0) return true;
    return !err_;
  }

  void scan(int64_t max_vars, ScanView* v) {
    if (returned_) start_batch();
    for (;;) {
      if (has_pushed_) {
        has_pushed_ = false;
        if (step(pushed_, max_vars)) return finish(v, 0);
        continue;
      }
      int64_t s, n;
      if (!next_line(&s, &n)) {
        if (err_) return finish(v, 2);
        if (block_open_ && !done_) flush();
        done_ = true;
        return finish(v, 0);
      }
      if (n == 0) continue;
      if (parse(s, n, cur_) != 0) {
        rej_off_ = s;
        rej_len_ = n;
        return finish(v, 1);
      }
      if (step(cur_, max_vars)) return finish(v, 0);
    }
  }

  // Python's reading of the line the scan handed over (status 1).
  void put(const uint8_t* name, int64_t name_len, bool passing, int64_t pos, int64_t ref_size,
           int64_t min_size) {
    Parsed& p = pushed_;
    p.line_off = rej_off_;
    p.line_len = rej_len_;
    p.gt_off = p.gt_len = 0;
    p.gt_at = -1;
    p.pos = pos;
    p.ref_size = ref_size;
    p.min_size = p.max_size = min_size;
    p.thresh = pos + ref_size - min_size - 1 + half_k_;
    p.name = intern(name, name_len);
    p.present = true;
    p.passing = passing;
    p.from_py = true;
    p.qual = 0;
    p.alleles.clear();
    p.id.clear();
    p.al_len.clear();
    p.freqs.clear();
    has_pushed_ = true;
  }

 private:
  // -- the text --------------------------------------------------------------
  bool fill() {
    if ((int64_t)buf_.size() - filled_ < (4 << 20))
      buf_.resize(std::max<size_t>(buf_.size() * 2, (size_t)filled_ + (8 << 20)));
    if (!gz_) {
      size_t got = std::fread(buf_.data() + filled_, 1, buf_.size() - filled_, f_);
      filled_ += (int64_t)got;
      if (got == 0) {
        if (std::ferror(f_)) return fail();
        eof_ = true;
      }
      return true;
    }
#if defined(MALVA_ZLIB)
    int64_t before = filled_;
    while (filled_ == before && !eof_) {
      if (zs_.avail_in == 0) {
        size_t got = std::fread(in_.data(), 1, in_.size(), f_);
        if (got == 0) {
          if (std::ferror(f_) || !member_done_) return fail();  // a truncated member
          eof_ = true;
          break;
        }
        zs_.next_in = in_.data();
        zs_.avail_in = (uInt)got;
      }
      if (member_done_) {  // between members: zero padding, then a header
        while (zs_.avail_in && *zs_.next_in == 0) {
          ++zs_.next_in;
          --zs_.avail_in;
        }
        if (zs_.avail_in == 0) continue;
        if (inflateReset(&zs_) != Z_OK) return fail();
        member_done_ = false;
      }
      zs_.next_out = buf_.data() + filled_;
      zs_.avail_out = (uInt)std::min<size_t>(buf_.size() - filled_, (size_t)1 << 30);
      uInt room = zs_.avail_out;
      int rc = inflate(&zs_, Z_NO_FLUSH);
      filled_ += (int64_t)(room - zs_.avail_out);
      if (rc == Z_STREAM_END) {
        member_done_ = true;
      } else if (rc != Z_OK && !(rc == Z_BUF_ERROR && zs_.avail_in == 0)) {
        return fail();
      }
    }
    return true;
#else
    return fail();
#endif
  }

  bool fail() {
    err_ = eof_ = true;
    return false;
  }

  bool next_line(int64_t* s, int64_t* n) {
    for (;;) {
      const uint8_t* b = buf_.data();
      const void* nl =
          filled_ > pos_ ? std::memchr(b + pos_, '\n', (size_t)(filled_ - pos_)) : nullptr;
      if (nl) {
        *s = pos_;
        *n = (const uint8_t*)nl - (b + pos_);
        pos_ += *n + 1;
        return true;
      }
      if (eof_) {
        if (err_ || pos_ >= filled_) return false;
        *s = pos_;
        *n = filled_ - pos_;
        pos_ = filled_;
        return true;
      }
      if (!fill()) return false;
    }
  }

  // -- one record --------------------------------------------------------------
  int32_t intern(const uint8_t* s, int64_t n) {
    if (last_intern_ >= 0) {
      int64_t o = name_off_[last_intern_], m = name_off_[last_intern_ + 1] - o;
      if (m == n && std::memcmp(name_bytes_.data() + o, s, (size_t)n) == 0) return last_intern_;
    }
    std::string key((const char*)s, (size_t)n);
    auto it = names_.find(key);
    if (it == names_.end()) {
      it = names_.emplace(std::move(key), (int32_t)names_.size()).first;
      name_bytes_.insert(name_bytes_.end(), s, s + n);
      name_off_.push_back((int64_t)name_bytes_.size());
    }
    return last_intern_ = it->second;
  }

  // VcfReader's columns and Variant's fields of the line at [at, at + n):
  // 0, or 1 where Python reads the line.
  int parse(int64_t at, int64_t n, Parsed& p) {
    const uint8_t* L = buf_.data() + at;
    int64_t c[10], cl[10];  // line.split(b"\t", 9)
    int nc = 0;
    int64_t start = 0;
    for (; nc < 9; ++nc) {
      const void* t = std::memchr(L + start, '\t', (size_t)(n - start));
      c[nc] = start;
      if (!t) {
        cl[nc++] = n - start;
        break;
      }
      cl[nc] = (const uint8_t*)t - (L + start);
      start += cl[nc] + 1;
    }
    if (nc == 9) {
      c[9] = start;
      cl[9] = n - start;
      nc = 10;
    }
    if (nc < 8) return 1;  // too few columns: Python raises
    for (int j = 0; j < std::min(nc, 9); ++j)
      for (int64_t i = 0; i < cl[j]; ++i)
        if (L[c[j] + i] >= 0x80) return 1;
    p.line_off = at;
    p.line_len = n;
    p.from_py = false;
    const uint8_t* chrom = L + c[0];
    int64_t chrom_n = cl[0];
    if (strip_chr_ && chrom_n >= 3 && std::memcmp(chrom, "chr", 3) == 0) {
      chrom += 3;
      chrom_n -= 3;
    }
    int64_t pos1;
    if (!parse_int(L + c[1], cl[1], &pos1)) return 1;
    p.pos = pos1 - 1;
    p.id.assign((const char*)L + c[2], (size_t)cl[2]);
    // REF, then the ALTs that are not symbolic, uppercased
    p.alleles.clear();
    p.al_len.clear();
    for (int64_t i = 0; i < cl[3]; ++i) p.alleles.push_back(upper(L[c[3] + i]));
    p.al_len.push_back(cl[3]);
    const uint8_t* alt = L + c[4];
    if (!(cl[4] == 1 && alt[0] == '.')) {
      for (int64_t i = 0, a0 = 0; i <= cl[4]; ++i) {
        if (i < cl[4] && alt[i] != ',') continue;
        if (!(i > a0 && alt[a0] == '<')) {
          for (int64_t j = a0; j < i; ++j) p.alleles.push_back(upper(alt[j]));
          p.al_len.push_back(i - a0);
        }
        a0 = i + 1;
      }
    }
    const uint8_t* q = L + c[5];
    if (cl[5] == 0 || (cl[5] == 1 && q[0] == '.')) {
      p.qual = std::nanf("");
    } else {
      double d;
      if (parse_float(q, cl[5], &d) != 0) return 1;  // Python raises, or reads it
      p.qual = (float)d;
    }
    int64_t n_alts = (int64_t)p.al_len.size() - 1;
    bool has_alts = n_alts > 0;
    p.ref_size = cl[3];
    p.min_size = p.max_size = 0;
    p.present = true;
    p.gt_at = -1;
    p.freqs.clear();
    if (has_alts) {
      int64_t mn = p.ref_size, mx = p.ref_size;
      for (int64_t a = 1; a <= n_alts; ++a) {
        mn = std::min(mn, p.al_len[a]);
        mx = std::max(mx, p.al_len[a]);
      }
      p.min_size = mn;
      p.max_size = mx;
      if (uniform_) {
        p.freqs.assign((size_t)n_alts + 1, 1.0f / (float)(n_alts + 1));
      } else {
        // VcfRecord.info_floats: the first segment that is the key or
        // starts with "key="; values past the ALTs are read and dropped
        p.freqs.assign((size_t)n_alts + 1, 0.0f);
        const uint8_t* info = L + c[7];
        int64_t in_n = cl[7], lk = (int64_t)key_.size();
        for (int64_t k = find(info, in_n, key_, 0); k != -1; k = find(info, in_n, key_, k + 1)) {
          if (k != 0 && info[k - 1] != ';') continue;
          int64_t end = k + lk;
          if (end == in_n || info[end] == ';') break;  // a flag: no values
          if (info[end] != '=') continue;
          int64_t t0 = end + 1, seg_end = t0;
          while (seg_end < in_n && info[seg_end] != ';') ++seg_end;
          for (int64_t i = t0, vi = 0; i <= seg_end; ++i) {
            if (i < seg_end && info[i] != ',') continue;
            double d;
            int rc = parse_float(info + t0, i - t0, &d);
            if (rc == 2) return 1;
            if (vi < n_alts) p.freqs[(size_t)vi + 1] = rc == 0 ? (float)d : std::nanf("");
            ++vi;
            t0 = i + 1;
          }
          break;
        }
        double sum = 0.0;  // accumulate(..., 0.0) runs in double
        for (float x : p.freqs) sum += (double)x;
        float r = (float)(1.0 - sum);
        p.freqs[0] = r < 0 ? 0.0f : r;
      }
      p.present = !(p.freqs[0] == 1.0f);
      if (p.present) {  // the GT subfield, or no GT data: has_alts flips off
        int64_t gi = -1;
        if (nc > 8 && n_samples_ > 0) {
          const uint8_t* fm = L + c[8];
          for (int64_t i = 0, f0 = 0, idx = 0; i <= cl[8]; ++i) {
            if (i < cl[8] && fm[i] != ':') continue;
            if (i - f0 == 2 && fm[f0] == 'G' && fm[f0 + 1] == 'T') {
              gi = idx;
              break;
            }
            ++idx;
            f0 = i + 1;
          }
        }
        if (gi < 0) {
          has_alts = false;
        } else {
          p.gt_at = gi;
          p.gt_off = nc > 9 ? at + c[9] : 0;
          p.gt_len = nc > 9 ? cl[9] : 0;
        }
      }
    }
    p.name = intern(chrom, chrom_n);
    p.passing = has_alts && (keep_absent_ || p.present);
    p.thresh = p.pos + p.ref_size - p.min_size - 1 + half_k_;  // blocks.are_near
    return 0;
  }

  // -- the blocks (pipeline._iter_blocks) --------------------------------------
  // true when the batch is full, p waiting for the next one.
  bool step(Parsed& p, int64_t max_vars) {
    ++n_lines_;
    if (!have_first_) {
      have_first_ = true;
      last_name_ = p.name;
      used_.push_back(p.name);
    }
    if (!p.passing) return false;
    if (!block_open_) {
      block_open_ = true;
      append(p);
      return false;
    }
    if (!(last_thresh_ >= p.pos) || last_name_ != p.name) {
      flush();
      if (last_name_ != p.name) {
        last_name_ = p.name;
        used_.push_back(p.name);
      }
      if (nv_ >= max_vars) {
        std::swap(waiting_, p);
        has_waiting_ = true;
        return true;
      }
    }
    append(p);
    return false;
  }

  void flush() {
    blk_off_.push_back(nv_);
    blk_name_.push_back(last_name_);
  }

  void append(const Parsed& p) {
    line_off_.push_back(p.line_off);
    line_len_.push_back(p.line_len);
    bool gt = p.present && p.gt_at >= 0;
    gt_off_.push_back(gt ? p.gt_off : 0);
    gt_len_.push_back(gt ? p.gt_len : 0);
    gt_at_.push_back(gt ? p.gt_at : -1);
    pos_col_.push_back(p.pos);
    ref_size_.push_back(p.ref_size);
    min_size_.push_back(p.min_size);
    max_size_.push_back(p.max_size);
    present_.push_back(p.present ? 1 : 0);
    qual_.push_back(p.qual);
    name_.push_back(p.name);
    int64_t o = al_off_.back();
    for (int64_t len : p.al_len) al_off_.push_back(o += len);
    al_start_.push_back((int64_t)al_off_.size() - 1);
    al_bytes_.insert(al_bytes_.end(), p.alleles.begin(), p.alleles.end());
    freq_.insert(freq_.end(), p.freqs.begin(), p.freqs.end());
    freq_.resize(al_off_.size() - 1, 0.0f);
    id_bytes_.insert(id_bytes_.end(), p.id.begin(), p.id.end());
    id_off_.push_back((int64_t)id_bytes_.size());
    fallback_ = fallback_ || p.from_py;
    last_thresh_ = p.thresh;
    ++nv_;
  }

  // A new batch: the text before its first record goes, the columns empty.
  void start_batch() {
    returned_ = false;
    int64_t keep = has_waiting_ ? waiting_.line_off : pos_;
    if (keep > 0) {
      std::memmove(buf_.data(), buf_.data() + keep, (size_t)(filled_ - keep));
      filled_ -= keep;
      pos_ -= keep;
      if (has_waiting_) {
        waiting_.line_off -= keep;
        if (waiting_.gt_at >= 0) waiting_.gt_off -= keep;
      }
    }
    for (auto* col : {&line_off_, &line_len_, &gt_off_, &gt_len_, &gt_at_, &pos_col_,
                      &ref_size_, &min_size_, &max_size_, &id_off_, &al_start_, &al_off_,
                      &blk_off_})
      col->clear();
    present_.clear();
    al_bytes_.clear();
    id_bytes_.clear();
    qual_.clear();
    freq_.clear();
    name_.clear();
    blk_name_.clear();
    used_.clear();
    al_start_.push_back(0);
    al_off_.push_back(0);
    id_off_.push_back(0);
    blk_off_.push_back(0);
    nv_ = 0;
    fallback_ = false;
    if (has_waiting_) {
      has_waiting_ = false;
      append(waiting_);
    }
  }

  void finish(ScanView* v, int64_t status) {
    v->status = status;
    returned_ = status == 0;
    v->n_vars = nv_;
    v->n_blocks = (int64_t)blk_name_.size();
    v->n_lines = n_lines_;
    v->n_used = (int64_t)used_.size();
    v->n_names = (int64_t)names_.size();
    v->fallback = fallback_;
    v->rec_off = rej_off_;
    v->rec_len = rej_len_;
    v->buf = buf_.data();
    v->line_off = line_off_.data();
    v->line_len = line_len_.data();
    v->gt_off = gt_off_.data();
    v->gt_len = gt_len_.data();
    v->gt_at = gt_at_.data();
    v->pos = pos_col_.data();
    v->ref_size = ref_size_.data();
    v->min_size = min_size_.data();
    v->max_size = max_size_.data();
    v->present = present_.data();
    v->qual = qual_.data();
    v->name = name_.data();
    v->al_start = al_start_.data();
    v->al_off = al_off_.data();
    v->al_bytes = al_bytes_.data();
    v->freq = freq_.data();
    v->id_off = id_off_.data();
    v->id_bytes = id_bytes_.data();
    v->blk_off = blk_off_.data();
    v->blk_name = blk_name_.data();
    v->used = used_.data();
    v->name_off = name_off_.data();
    v->name_bytes = name_bytes_.data();
  }

  FILE* f_;
  bool gz_, err_ = false, eof_ = false;
#if defined(MALVA_ZLIB)
  z_stream zs_;
  bool zinit_ = false, member_done_ = false;
#endif
  std::vector<uint8_t> in_, buf_;
  int64_t filled_ = 0, pos_ = 0;

  int64_t n_samples_;
  std::string key_;
  bool uniform_, strip_chr_, keep_absent_;
  int64_t half_k_;

  Parsed cur_, waiting_, pushed_;
  bool has_waiting_ = false, has_pushed_ = false, returned_ = true, done_ = false;
  int64_t rej_off_ = 0, rej_len_ = 0;

  int64_t n_lines_ = 0, last_thresh_ = 0, nv_ = 0;
  bool have_first_ = false, block_open_ = false, fallback_ = false;
  int32_t last_name_ = -1, last_intern_ = -1;

  std::unordered_map<std::string, int32_t> names_;
  std::vector<int64_t> name_off_;
  std::vector<uint8_t> name_bytes_;

  std::vector<int64_t> line_off_, line_len_, gt_off_, gt_len_, gt_at_, pos_col_, ref_size_,
      min_size_, max_size_, id_off_, al_start_, al_off_, blk_off_;
  std::vector<uint8_t> present_, al_bytes_, id_bytes_;
  std::vector<float> qual_, freq_;
  std::vector<int32_t> name_, blk_name_, used_;
};

}  // namespace

extern "C" {

// 1 where the library inflates gzip itself (built with zlib), else 0.
int malva_has_zlib() {
#if defined(MALVA_ZLIB)
  return 1;
#else
  return 0;
#endif
}

// A scanner over the VCF at path, past its header, or NULL where it
// cannot take the file (unreadable, gzip without zlib, a stream that fails
// in the header).  k is the blocks' k, keep_absent the call phase's rule
// (pipeline._iter_blocks), n_samples the header's sample count.
void* malva_vcf_open(const char* path, int64_t n_samples, const char* freq_key, int uniform,
                     int strip_chr, int keep_absent, int64_t k) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  unsigned char magic[2] = {0, 0};
  bool gz = std::fread(magic, 1, 2, f) == 2 && magic[0] == 0x1f && magic[1] == 0x8b;
  std::rewind(f);
  auto* s = new VcfScan(f, gz, n_samples, freq_key, uniform != 0, strip_chr != 0,
                        keep_absent != 0, k);
  if (!s->open()) {
    delete s;
    return nullptr;
  }
  return s;
}

// The next batch: whole blocks until at least max_vars variants, or the
// next line for Python (see ScanView).
void malva_vcf_scan(void* h, int64_t max_vars, ScanView* out) {
  static_cast<VcfScan*>(h)->scan(max_vars, out);
}

// Python's reading of the line the last scan handed over: its contig
// (after strip_chr), whether it enters a block, its POS - 1, its REF's
// length and its shortest allele's (0 without ALTs).
void malva_vcf_put(void* h, const uint8_t* name, int64_t name_len, int passing, int64_t pos,
                   int64_t ref_size, int64_t min_size) {
  static_cast<VcfScan*>(h)->put(name, name_len, passing != 0, pos, ref_size, min_size);
}

void malva_vcf_close(void* h) { delete static_cast<VcfScan*>(h); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Build facts for the loader (malva_tpu_torch/utils/native.py): how many
// threads the OpenMP loops above run on, and which of the loader's build
// forms this library is.

#ifndef MALVA_BUILD_FORM
#define MALVA_BUILD_FORM "unknown"
#endif

extern "C" {

// The team size of a parallel region here: OpenMP's (OMP_NUM_THREADS,
// else one thread per core), or 1 in a build without OpenMP.
int malva_threads() {
  int n = 1;
#if defined(_OPENMP)
#pragma omp parallel
  {
#pragma omp single
    n = omp_get_num_threads();
  }
#endif
  return n;
}

const char* malva_build_form() { return MALVA_BUILD_FORM; }

}  // extern "C"
