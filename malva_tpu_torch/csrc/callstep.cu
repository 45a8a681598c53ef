// K1: the call-phase query/update step over packed sample contexts.
//
// Replaces malva_tpu/ops/pallas_kernels.py:125 make_callstep_hash_fn (the
// front end) together with the XLA rest of index/device.py:400
// make_call_step_packed.  Per lane: canonical centred k-mer in 2-bit
// space, its XXH3, the Bloom index, one 8-byte gather of the (W, 2)
// word+rank row, and the mini-filter test.  Only a lane that hits the alt
// filter or is an exact-map candidate goes on: the context XXH3 and the
// context-filter test, an atomicAdd into the rank-compressed counters,
// and the two-bucket probe with an atomicAdd into the exact-map values.
// The kernel is step.cuh's step_body with K1's policy (every Bloom word
// is this launch's; a context is known where its XXH3's bit is set in the
// context filter); K4 (shard_step.cu) is the same template.
//
// Bound: bytes.  Per lane the kernel must read its packed context and
// counter (16 B at ref_k 43) and one random 8-byte row of a GiB-sized
// array, whose 32-byte sector is the real cost; the hashing is a few
// hundred integer instructions (chip_smoke.py counts both: 0.0178 ms per
// 2^21 lanes, bytes).  The card serves such random reads far below its
// byte rate, so the practical floor is the gathers themselves (chip_smoke.py
// times torch's gather of the same rows beside the kernel, `gather_ms`),
// plus the tails' own random reads and atomics.
//
// Both launchers take an optional pair of CUDA events and record them just
// before and after the launch, inside the same C call (launch.cuh), so the
// time between them is the kernel's device time even while other Python
// threads hold the GIL.
#include <cuda_runtime.h>

#include "step.cuh"

using namespace malva;

namespace {

// Hash-only mode: exactly the TPU kernel's outputs, one plane of B words
// each: [ctx_hi, ctx_lo,] c_hi, c_lo, can_0 .. can_{w_k-1}.
template <int N>
__global__ void __launch_bounds__(kStepThreads, 4)
    callstep_hash_kernel(const uint32_t* __restrict__ ctx, int64_t B, int k, int ref_k,
                         int with_ctx, uint32_t* __restrict__ out) {
  using S = Shape<N>;
  __shared__ __align__(16) uint32_t tiles[kStepWarps][S::kTileWords];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* tile = tiles[warp];
  const int64_t n_tiles = (B + S::kTileLanes - 1) / S::kTileLanes;
  const int w_k = (k + 15) / 16;
  for (int64_t t = (int64_t)blockIdx.x * kStepWarps + warp; t < n_tiles;
       t += (int64_t)gridDim.x * kStepWarps) {
    const int64_t first = t * S::kTileLanes;
    stage_tile<N>(tile, nullptr, ctx, nullptr, first, B, lane);
    staged_wait();
#pragma unroll 1
    for (int r = 0; r < S::kLanes; ++r) {
      const int64_t i = first + r * 32 + lane;
      if (i >= B) continue;
      uint32_t w[N], can[N];
      staged_context(tile, r * 32 + lane, w);
      int at = 0;
      if (with_ctx) {
        const uint64_t x = xxh3_64(PackedBases<N>(w), ref_k);
        out[i] = (uint32_t)(x >> 32);
        out[B + i] = (uint32_t)x;
        at = 2;
      }
      const uint64_t c = centre_hash(w, k, ref_k, can);
      out[at * B + i] = (uint32_t)(c >> 32);
      out[(at + 1) * B + i] = (uint32_t)c;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j < w_k) out[(at + 2 + j) * B + i] = can[j];
    }
  }
}

// K1's policy (step.cuh): the launch holds every Bloom word; a lane's
// context is known where the context filter has the bit of its XXH3.
struct CallstepPolicy : ContiguousLanes {
  static constexpr Carry kCarry = Carry::kNothing;
  const uint32_t* __restrict__ ctx_words;

  __device__ __forceinline__ bool owns(uint64_t) const { return true; }
  __device__ __forceinline__ int64_t row(uint64_t idx) const { return (int64_t)(idx >> 5); }
  template <int N>
  __device__ __forceinline__ uint32_t context_word(const uint32_t (&w)[N], uint32_t, int ref_k,
                                                   uint64_t size_bits, uint32_t& bit) const {
    const uint64_t x = bloom_index(xxh3_64(PackedBases<N>(w), ref_k), size_bits);
    bit = (uint32_t)(x & 31);
    return __ldg(ctx_words + (x >> 5));
  }
};

template <int N>
__global__ void __launch_bounds__(kStepThreads, Shape<N>::kMinBlocks)
    callstep_kernel(const uint32_t* __restrict__ ctx, const uint32_t* __restrict__ counters,
                    int64_t B, int k, int ref_k, const uint2* __restrict__ bf_packed,
                    const uint32_t* __restrict__ ctx_words, const uint32_t* __restrict__ kmap_keys,
                    uint32_t* __restrict__ state, int64_t counts_len, uint64_t n_buckets,
                    uint64_t size_bits, int minifilter) {
  step_body<N>(CallstepPolicy{{}, ctx_words}, ctx, counters, B, k, ref_k, bf_packed, kmap_keys, state,
               counts_len, n_buckets, size_bits, minifilter);
}

template <int N>
int launch_hash(const uint32_t* ctx, int64_t B, int k, int ref_k, int with_ctx, uint32_t* out,
                void* ev_start, void* ev_stop, cudaStream_t stream) {
  int grid = 0;
  const int e = step_grid<N>(callstep_hash_kernel<N>, B, &grid);
  if (e != 0) return e;
  return launch_timed(ev_start, ev_stop, stream, [&](cudaStream_t s) {
    callstep_hash_kernel<N><<<grid, kStepThreads, 0, s>>>(ctx, B, k, ref_k, with_ctx, out);
  });
}

template <int N>
int launch_step(const uint32_t* ctx, const uint32_t* counters, int64_t B, int k, int ref_k,
                const uint2* bf_packed, const uint32_t* ctx_words, const uint32_t* kmap_keys,
                uint32_t* state, int64_t counts_len, uint64_t n_buckets, uint64_t size_bits,
                int minifilter, void* ev_start, void* ev_stop, cudaStream_t stream) {
  int grid = 0;
  const int e = step_grid<N>(callstep_kernel<N>, B, &grid);
  if (e != 0) return e;
  return launch_timed(ev_start, ev_stop, stream, [&](cudaStream_t s) {
    callstep_kernel<N><<<grid, kStepThreads, 0, s>>>(ctx, counters, B, k, ref_k, bf_packed,
                                                    ctx_words, kmap_keys, state, counts_len,
                                                    n_buckets, size_bits, minifilter);
  });
}

}  // namespace

extern "C" {

int malva_callstep_hash(const void* ctx, int64_t B, int wc, int k, int ref_k, int with_ctx,
                        void* out, void* ev_start, void* ev_stop, void* stream) {
  if (B <= 0) return launch_timed(ev_start, ev_stop, (cudaStream_t)stream, [](cudaStream_t) {});
  switch (wc) {
#define MALVA_K1_HASH(n)                                                                   \
  case n:                                                                                  \
    return launch_hash<n>((const uint32_t*)ctx, B, k, ref_k, with_ctx, (uint32_t*)out,     \
                          ev_start, ev_stop, (cudaStream_t)stream);
    MALVA_WORD_COUNTS(MALVA_K1_HASH)
#undef MALVA_K1_HASH
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int malva_callstep(const void* ctx, const void* counters, int64_t B, int wc, int k, int ref_k,
                   const void* bf_packed, const void* ctx_words, const void* kmap_keys,
                   void* state, int64_t counts_len, int64_t n_buckets, int64_t size_bits,
                   int minifilter, void* ev_start, void* ev_stop, void* stream) {
  if (B <= 0) return launch_timed(ev_start, ev_stop, (cudaStream_t)stream, [](cudaStream_t) {});
  switch (wc) {
#define MALVA_K1_STEP(n)                                                                     \
  case n:                                                                                    \
    return launch_step<n>((const uint32_t*)ctx, (const uint32_t*)counters, B, k, ref_k,      \
                          (const uint2*)bf_packed, (const uint32_t*)ctx_words,               \
                          (const uint32_t*)kmap_keys, (uint32_t*)state, counts_len,          \
                          (uint64_t)n_buckets, (uint64_t)size_bits, minifilter, ev_start,    \
                          ev_stop, (cudaStream_t)stream);
    MALVA_WORD_COUNTS(MALVA_K1_STEP)
#undef MALVA_K1_STEP
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
