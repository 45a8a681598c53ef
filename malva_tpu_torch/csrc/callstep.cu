// K1: the call-phase query/update step, one thread per sample context.
//
// Replaces malva_tpu/ops/pallas_kernels.py:125 make_callstep_hash_fn (the
// front end) together with the XLA rest of index/device.py:400
// make_call_step_packed.  Per lane: canonical centered k-mer in 2-bit
// space, its XXH3, the Bloom index, one 8-byte gather of the (W, 2)
// word+rank row, and the mini-filter test.  Only a lane that hits the alt
// filter or is an exact-map candidate goes on: the context XXH3 and the
// context-filter test, an atomicAdd into the rank-compressed counters,
// and the two-bucket probe with an atomicAdd into the exact-map values.
//
// Bound: one random 8-byte read of a GiB-sized array per lane (the row
// gather), plus rare tails; the hashing is a few hundred integer ops.
// uint32 adds commute, so the final state does not depend on thread
// order and is bit-exact with the plain step (ops/kernels.py).
//
// The TPU's lane compaction (segmented sort, tiered tails, lax.cond tree)
// is not carried over: a thread that has nothing to do just returns.
#include <cuda_runtime.h>

#include "lanes.cuh"

using namespace malva;

namespace {

constexpr int kThreads = 256;

// Hash-only mode: exactly the TPU kernel's outputs, one plane of B words
// each: [ctx_hi, ctx_lo,] c_hi, c_lo, can_0 .. can_{w_k-1}.
__global__ void callstep_hash_kernel(const uint32_t* __restrict__ ctx, int64_t B, int wc,
                                     int k, int ref_k, int with_ctx,
                                     uint32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  uint32_t w[kMaxWords], can[kMaxWords];
  uint8_t buf[kMaxLen];
  for (int j = 0; j < wc; ++j) w[j] = ctx[i * wc + j];
  int at = 0;
  if (with_ctx) {
    decode_ascii(w, ref_k, buf);
    const uint64_t x = xxh3_64(buf, ref_k);
    out[i] = (uint32_t)(x >> 32);
    out[B + i] = (uint32_t)x;
    at = 2;
  }
  canonical_center(w, k, ref_k, buf, can);
  const uint64_t c = xxh3_64(buf, k);
  out[at * B + i] = (uint32_t)(c >> 32);
  out[(at + 1) * B + i] = (uint32_t)c;
  for (int j = 0; j < (k + 15) / 16; ++j) out[(at + 2 + j) * B + i] = can[j];
}

__global__ void callstep_kernel(const uint32_t* __restrict__ ctx,
                                const uint32_t* __restrict__ counters, int64_t B, int wc,
                                int k, int ref_k, const uint2* __restrict__ bf_packed,
                                const uint32_t* __restrict__ ctx_words,
                                const uint32_t* __restrict__ kmap_keys,
                                uint32_t* __restrict__ state, int64_t counts_len,
                                uint64_t n_buckets, uint64_t size_bits, int minifilter) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const uint32_t cnt = counters[i];
  if (cnt == 0) return;  // adding 0 is a no-op everywhere (padding lanes)
  uint32_t w[kMaxWords], can[kMaxWords];
  uint8_t buf[kMaxLen];
  for (int j = 0; j < wc; ++j) w[j] = ctx[i * wc + j];

  canonical_center(w, k, ref_k, buf, can);
  const uint64_t c = xxh3_64(buf, k);
  const uint64_t idx = bloom_index(c, size_bits);
  const uint32_t bit = (uint32_t)(idx & 31);
  const uint2 row = bf_packed[idx >> 5];
  const bool is_set = (row.x >> bit) & 1u;
  bool cand = true;
  if (minifilter && n_buckets > 1)
    cand = ((row.y >> kRankBits) >> (uint32_t)((c >> 60) & 3)) & 1u;

  if (is_set) {
    decode_ascii(w, ref_k, buf);
    const uint64_t x = xxh3_64(buf, ref_k);
    if (!bit_is_set(ctx_words, bloom_index(x, size_bits))) {
      const uint32_t rank = minifilter ? (row.y & kRankMask) : row.y;
      atomicAdd(state + (rank + popc32(row.x & ((1u << bit) - 1u))), cnt);
    }
  }
  if (cand) {
    const int64_t slot = probe_buckets(kmap_keys, n_buckets, (k + 15) / 16, can, c);
    if (slot >= 0) atomicAdd(state + counts_len + slot, cnt);
  }
}

int grid_for(int64_t n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

int malva_callstep_hash(const void* ctx, int64_t B, int wc, int k, int ref_k, int with_ctx,
                        void* out, void* stream) {
  if (B > 0)
    callstep_hash_kernel<<<grid_for(B), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)ctx, B, wc, k, ref_k, with_ctx, (uint32_t*)out);
  return (int)cudaGetLastError();
}

int malva_callstep(const void* ctx, const void* counters, int64_t B, int wc, int k, int ref_k,
                   const void* bf_packed, const void* ctx_words, const void* kmap_keys,
                   void* state, int64_t counts_len, int64_t n_buckets, int64_t size_bits,
                   int minifilter, void* stream) {
  if (B > 0)
    callstep_kernel<<<grid_for(B), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)ctx, (const uint32_t*)counters, B, wc, k, ref_k,
        (const uint2*)bf_packed, (const uint32_t*)ctx_words, (const uint32_t*)kmap_keys,
        (uint32_t*)state, counts_len, (uint64_t)n_buckets, (uint64_t)size_bits, minifilter);
  return (int)cudaGetLastError();
}

}  // extern "C"
