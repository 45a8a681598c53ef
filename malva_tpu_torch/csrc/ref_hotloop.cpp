// The port's copy of native/ref_hotloop.cpp, unchanged below this comment:
// the C++ baseline of malva_tpu_torch/bench.py.  The port links it against
// xxh3_shim.cpp (XXH3_64bits over this package's xxh3.cuh) instead of the
// reference's vendored xxhash.c, so it builds from this package alone:
//   g++ -O3 -march=native -o ref_hotloop ref_hotloop.cpp xxh3_shim.cpp
//
// Single-thread CPU baseline of the genotyper's call-phase hot loop
// (reference: main.cpp:487-500 semantics — per distinct sample context:
// canonical 43-mer probe of the context filter, canonical centered 35-mer
// hash, rank-compressed counter add, exact-map lookup), written fresh for
// benchmarking.  Links against the reference's vendored xxhash.c at build
// time (see bench.py) so the hash cost is the real one.
//
// Usage: ref_hotloop <log2_bits> <n_kmers> <iters> [n_and] [kmap_keys]
//   n_and = 0: legacy sparse fill (~3e-6 bit density)
//   n_and = k: every word = AND of k random words (density 2^-k; 6 -> the
//              WGS-like 1.6e-2 the TPU bench uses)
//   kmap_keys: exact-map size (default 1e6)
// Prints: kmers_per_sec=<float>

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <unordered_map>
#include <string>
#include <vector>

extern "C" uint64_t XXH3_64bits(const void* data, size_t len);

static const int K = 35, REFK = 43, OFF = 4;

static char RC[256];

static void canonical(const char* kmer, char* out, int k) {
    for (int i = 0; i < k; ++i) out[i] = RC[(unsigned char)kmer[k - 1 - i]];
    out[k] = 0;
    if (memcmp(kmer, out, k) < 0) memcpy(out, kmer, k);
}

int main(int argc, char** argv) {
    int log2_bits = argc > 1 ? atoi(argv[1]) : 33;
    long n = argc > 2 ? atol(argv[2]) : (1 << 22);
    int iters = argc > 3 ? atoi(argv[3]) : 3;
    int n_and = argc > 4 ? atoi(argv[4]) : 0;
    long kmap_n = argc > 5 ? atol(argv[5]) : 1000000;

    memset(RC, 0, sizeof RC);
    RC['A'] = 'T'; RC['C'] = 'G'; RC['G'] = 'C'; RC['T'] = 'A'; RC['N'] = 'N';

    const uint64_t size = 1ULL << log2_bits;
    const size_t nwords = size / 64;
    std::vector<uint64_t> bf(nwords), ctx(nwords);
    std::vector<uint32_t> rank(nwords);
    std::mt19937_64 rng(42);
    for (size_t i = 0; i < nwords; ++i) {
        if (n_and > 0) {
            uint64_t b = rng(), c = rng();
            for (int j = 1; j < n_and; ++j) { b &= rng(); c &= rng(); }
            bf[i] = b; ctx[i] = c;
        } else {
            // ~3e-6 fill: occasional single bit per word
            bf[i] = (rng() % 10000 == 0) ? (1ULL << (rng() & 63)) : 0;
            ctx[i] = (rng() % 10000 == 0) ? (1ULL << (rng() & 63)) : 0;
        }
    }
    uint32_t acc = 0;
    for (size_t i = 0; i < nwords; ++i) { rank[i] = acc; acc += __builtin_popcountll(bf[i]); }
    std::vector<uint16_t> counts(acc ? acc : 1);

    std::unordered_map<std::string, int> kmap;
    {
        const char* al = "ACGT";
        for (long i = 0; i < kmap_n; ++i) {
            char buf[K + 1];
            for (int j = 0; j < K; ++j) buf[j] = al[rng() & 3];
            buf[K] = 0;
            kmap[buf] = 0;
        }
    }

    std::vector<char> data(n * REFK);
    const char* al = "ACGT";
    for (long i = 0; i < n * REFK; ++i) data[i] = al[rng() & 3];

    volatile uint64_t sink = 0;
    auto t0 = std::chrono::steady_clock::now();
    for (int it = 0; it < iters; ++it) {
        for (long i = 0; i < n; ++i) {
            const char* context = &data[i * REFK];
            char cctx[REFK + 1];
            canonical(context, cctx, REFK);
            uint64_t hctx = XXH3_64bits(cctx, REFK) % size;
            bool ctx_known = (ctx[hctx >> 6] >> (hctx & 63)) & 1;

            char center[K + 1];
            memcpy(center, context + OFF, K);
            center[K] = 0;
            char ccen[K + 1];
            canonical(center, ccen, K);
            uint64_t h = XXH3_64bits(ccen, K) % size;
            uint64_t w = bf[h >> 6];
            if (!ctx_known && ((w >> (h & 63)) & 1)) {
                uint32_t ci = rank[h >> 6] + __builtin_popcountll(w & ((1ULL << (h & 63)) - 1));
                counts[ci] = (uint16_t)(counts[ci] + 7);
            }
            auto itr = kmap.find(std::string(ccen, K));
            if (itr != kmap.end()) itr->second += 7;
            sink += h;
        }
    }
    auto t1 = std::chrono::steady_clock::now();
    double secs = std::chrono::duration<double>(t1 - t0).count();
    printf("kmers_per_sec=%.1f\n", (double)n * iters / secs);
    return (int)(sink & 1) * 0;
}
