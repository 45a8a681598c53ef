// K4: the owner side of the routed sharded call step, one thread per
// routed lane.
//
// No Pallas counterpart: replaces the XLA tail of the routed step in
// malva_tpu/parallel/sharded_index.py:398-424 (make_routed_call_step), which
// runs on the shard that owns a lane's Bloom word.  A lane arrives as its
// packed context, its counter and the "context known" flag that the
// context-word owner found (hop 1).  The thread recomputes the canonical
// centre and its XXH3 (a few hundred integer ops, cheaper than receiving
// them) with K1's per-lane front end (lanes.cuh centre_hash, in registers:
// the context's word count N is a template parameter, 1..15), gathers the
// 8-byte [word, local rank] row of this shard's (W/S, 2) array, adds the
// counter into the rank-compressed counters when the Bloom bit is set and
// the context is not known, and probes this shard's two-bucket exact map
// (nbs buckets), adding the counter into the slot that holds the centre.
// The state is [bf_counts (counts_len) | kmap_vals].
//
// Bound, as K1: one random 8-byte row gather per lane plus the bucket
// probe; uint32 adds commute, so the state is exact whatever the thread
// order.  A lane whose Bloom word lies outside this shard (the routing
// never sends one) touches nothing.
#include <cuda_runtime.h>

#include "lanes.cuh"
#include "launch.cuh"

using namespace malva;

namespace {

constexpr int kThreads = 256;

template <int N>
__global__ void shard_update_kernel(const uint32_t* __restrict__ ctx,
                                    const uint32_t* __restrict__ counters,
                                    const uint8_t* __restrict__ known, int64_t B, int k,
                                    int ref_k, const uint2* __restrict__ bf_packed,
                                    int64_t word_base, int64_t n_words,
                                    const uint32_t* __restrict__ kmap_keys,
                                    uint32_t* __restrict__ state, int64_t counts_len,
                                    uint64_t n_buckets, uint64_t size_bits) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const uint32_t cnt = counters[i];
  if (cnt == 0) return;  // adding 0 is a no-op everywhere
  uint32_t w[N], can[N];
#pragma unroll
  for (int j = 0; j < N; ++j) w[j] = ctx[i * N + j];

  const uint64_t c = centre_hash(w, k, ref_k, can);
  const uint64_t idx = bloom_index(c, size_bits);
  const int64_t lw = (int64_t)(idx >> 5) - word_base;
  if (lw < 0 || lw >= n_words) return;
  const uint32_t bit = (uint32_t)(idx & 31);
  const uint2 row = bf_packed[lw];
  if (((row.x >> bit) & 1u) && !known[i])
    atomicAdd(state + (row.y + popc32(row.x & ((1u << bit) - 1u))), cnt);
  const int64_t slot = probe_buckets(kmap_keys, n_buckets, (k + 15) / 16, can, c);
  if (slot >= 0) atomicAdd(state + counts_len + slot, cnt);
}

}  // namespace

extern "C" {

int malva_shard_update(const void* ctx, const void* counters, const void* known, int64_t B,
                       int wc, int k, int ref_k, const void* bf_packed, int64_t word_base,
                       int64_t n_words, const void* kmap_keys, void* state, int64_t counts_len,
                       int64_t n_buckets, int64_t size_bits, void* ev_start, void* ev_stop,
                       void* stream) {
  if (wc < 1 || wc > 15) return (int)cudaErrorInvalidValue;
  return launch_timed(ev_start, ev_stop, (cudaStream_t)stream, [&](cudaStream_t s) {
    if (B <= 0) return;
    const int grid = (int)((B + kThreads - 1) / kThreads);
    switch (wc) {
#define MALVA_K4_CASE(n)                                                                        \
  case n:                                                                                       \
    shard_update_kernel<n><<<grid, kThreads, 0, s>>>(                                           \
        (const uint32_t*)ctx, (const uint32_t*)counters, (const uint8_t*)known, B, k, ref_k,    \
        (const uint2*)bf_packed, word_base, n_words, (const uint32_t*)kmap_keys,                \
        (uint32_t*)state, counts_len, (uint64_t)n_buckets, (uint64_t)size_bits);                \
    break;
      MALVA_K4_CASE(1) MALVA_K4_CASE(2) MALVA_K4_CASE(3) MALVA_K4_CASE(4) MALVA_K4_CASE(5)
      MALVA_K4_CASE(6) MALVA_K4_CASE(7) MALVA_K4_CASE(8) MALVA_K4_CASE(9) MALVA_K4_CASE(10)
      MALVA_K4_CASE(11) MALVA_K4_CASE(12) MALVA_K4_CASE(13) MALVA_K4_CASE(14) MALVA_K4_CASE(15)
#undef MALVA_K4_CASE
    }
  });
}

}  // extern "C"
