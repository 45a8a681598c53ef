// K4 and K5: the shard side of the two sharded call steps.
//
// K4, the owner side of the routed step.  No Pallas counterpart: replaces
// the XLA tail of the routed step in malva_tpu/parallel/sharded_index.py:
// 398-424 (make_routed_call_step), which runs on the shard that owns a
// lane's Bloom word.  A lane arrives as its packed context, its counter and
// the "context known" flag that the context-word owner found (hop 1).  The
// kernel recomputes the canonical centre and its XXH3 (a few hundred
// integer ops, cheaper than receiving them), gathers the 8-byte [word,
// local rank | mini-filter << 28] row of this shard's (W/S, 2) array, adds
// the counter into the rank-compressed counters when the Bloom bit is set
// and the context is not known, and, where the centre may be in this
// shard's exact map (its mini-filter bit is set, or the shard's rows carry
// no mini-filter), probes the map's two buckets (nbs buckets), adding the
// counter into the slot that holds the centre.  The state is [bf_counts
// (counts_len) | kmap_vals].
//
// K5, the shard side of the all-gather step.  No Pallas counterpart:
// replaces the XLA body of make_sharded_call_step in
// malva_tpu/parallel/sharded_index.py:141-183, which runs on every shard
// over the whole gathered batch.  Every lane comes to every shard, with the
// "context known" flag already OR-merged across the shards.  The shard
// holds Bloom words word_base .. word_base + n_words - 1 as [word, local
// rank] rows (no mini-filter) and buckets bucket_base .. bucket_base +
// n_local - 1 of ONE global bucket table of n_buckets.  Per lane: the
// counter add as K4's, where the lane's Bloom word is the shard's; and the
// exact-map add, gated neither by the Bloom bit nor by the flag, where one
// of the centre's two global buckets is the shard's: that bucket is probed
// (b1 before b2, lowest slot first, a bucket outside the range skipped
// without a read) and the slot taken relative to bucket_base.  A key lives
// in one bucket of one shard, so at most one shard adds it.
//
// Both kernels are K1's (step.cuh step_body), each with its policy: the
// row index is the word less the shard's first word, and the "known" flag
// is read in the tail from the `known` array at the lane's index, which
// the tail ring carries.  K4 takes only lanes whose Bloom word is the
// shard's (the routing sends no other).  K5 takes every lane of the batch
// and keeps live those whose Bloom word or one of whose buckets is the
// shard's (about 1/S + 2/S of them); it gathers a row only for the first
// and queues a lane for the tail where its Bloom bit is set or a bucket is
// the shard's.  So both have K1's staging, hashing before the gathers and
// batched tails, and K1's bound: one random 8-byte row gather per owned
// lane, plus the tails' reads; K5 also reads every lane's context and
// counter once (its bound is bytes: chip_smoke.py counts them).  uint32
// adds commute, so the state is exact whatever the thread order.
#include <cuda_runtime.h>

#include "step.cuh"

using namespace malva;

namespace {

// What K4 and K5 share: this shard holds words word_base .. word_base +
// n_words - 1; a lane's context is known where the step said so.
struct ShardRows {
  static constexpr bool kLaneIndex = true;
  const uint8_t* __restrict__ known;
  int64_t word_base, n_words;

  __device__ __forceinline__ bool owns(uint64_t idx) const {
    const int64_t lw = (int64_t)(idx >> 5) - word_base;
    return lw >= 0 && lw < n_words;
  }
  __device__ __forceinline__ int64_t row(uint64_t idx) const {
    return (int64_t)(idx >> 5) - word_base;
  }
  template <int N>
  __device__ __forceinline__ uint32_t context_word(const uint32_t (&)[N], uint32_t lane, int,
                                                   uint64_t, uint32_t& bit) const {
    bit = 0;
    return __ldg(known + lane);
  }
};

// K4's policy (step.cuh): only lanes whose Bloom word is the shard's, and
// the shard's own bucket table.
struct ShardPolicy : ShardRows, WholeMap {
  __device__ __forceinline__ bool live(uint64_t idx, uint64_t) const { return owns(idx); }
};

// K5's policy (step.cuh): lanes whose Bloom word or one of whose global
// buckets is the shard's; the shard's buckets bucket_base .. + n_local - 1
// of the global table of n_buckets.
struct GatherPolicy : ShardRows {
  uint64_t n_buckets, bucket_base, n_local;

  __device__ __forceinline__ bool in_map(uint64_t c) const {
    return bucket_in_range(c, n_buckets, bucket_base, n_local);
  }
  __device__ __forceinline__ bool live(uint64_t idx, uint64_t c) const {
    return owns(idx) || in_map(c);
  }
  __device__ __forceinline__ uint32_t what(const RowTest& rt, uint64_t c) const {
    return (rt.what & 1u) | (uint32_t)in_map(c) << 1;
  }
  template <int N>
  __device__ __forceinline__ int64_t probe(const uint32_t* keys, uint64_t, int w_k,
                                           const uint32_t (&can)[N], uint64_t h) const {
    return probe_buckets(keys, n_buckets, w_k, can, h, bucket_base, n_local);
  }
};

template <int N>
__global__ void __launch_bounds__(kStepThreads, Shape<N>::kMinBlocks)
    shard_update_kernel(const uint32_t* __restrict__ ctx, const uint32_t* __restrict__ counters,
                        const uint8_t* __restrict__ known, int64_t B, int k, int ref_k,
                        const uint2* __restrict__ bf_packed, int64_t word_base, int64_t n_words,
                        const uint32_t* __restrict__ kmap_keys, uint32_t* __restrict__ state,
                        int64_t counts_len, uint64_t n_buckets, uint64_t size_bits,
                        int minifilter) {
  step_body<N>(ShardPolicy{{known, word_base, n_words}, {}}, ctx, counters, B, k, ref_k,
               bf_packed, kmap_keys, state, counts_len, n_buckets, size_bits, minifilter);
}

template <int N>
__global__ void __launch_bounds__(kStepThreads, Shape<N>::kMinBlocks)
    gather_update_kernel(const uint32_t* __restrict__ ctx, const uint32_t* __restrict__ counters,
                         const uint8_t* __restrict__ known, int64_t B, int k, int ref_k,
                         const uint2* __restrict__ bf_packed, int64_t word_base, int64_t n_words,
                         const uint32_t* __restrict__ kmap_keys, uint32_t* __restrict__ state,
                         int64_t counts_len, uint64_t n_buckets, uint64_t bucket_base,
                         uint64_t n_local, uint64_t size_bits) {
  step_body<N>(GatherPolicy{{known, word_base, n_words}, n_buckets, bucket_base, n_local}, ctx,
               counters, B, k, ref_k, bf_packed, kmap_keys, state, counts_len, n_buckets,
               size_bits, 0);
}

template <int N>
int launch_shard(const uint32_t* ctx, const uint32_t* counters, const uint8_t* known, int64_t B,
                 int k, int ref_k, const uint2* bf_packed, int64_t word_base, int64_t n_words,
                 const uint32_t* kmap_keys, uint32_t* state, int64_t counts_len,
                 uint64_t n_buckets, uint64_t size_bits, int minifilter, void* ev_start,
                 void* ev_stop, cudaStream_t stream) {
  int grid = 0;
  const int e = step_grid<N>(shard_update_kernel<N>, B, &grid);
  if (e != 0) return e;
  return launch_timed(ev_start, ev_stop, stream, [&](cudaStream_t s) {
    shard_update_kernel<N><<<grid, kStepThreads, 0, s>>>(ctx, counters, known, B, k, ref_k,
                                                        bf_packed, word_base, n_words, kmap_keys,
                                                        state, counts_len, n_buckets, size_bits,
                                                        minifilter);
  });
}

template <int N>
int launch_gather(const uint32_t* ctx, const uint32_t* counters, const uint8_t* known, int64_t B,
                  int k, int ref_k, const uint2* bf_packed, int64_t word_base, int64_t n_words,
                  const uint32_t* kmap_keys, uint32_t* state, int64_t counts_len,
                  uint64_t n_buckets, uint64_t bucket_base, uint64_t n_local, uint64_t size_bits,
                  void* ev_start, void* ev_stop, cudaStream_t stream) {
  int grid = 0;
  const int e = step_grid<N>(gather_update_kernel<N>, B, &grid);
  if (e != 0) return e;
  return launch_timed(ev_start, ev_stop, stream, [&](cudaStream_t s) {
    gather_update_kernel<N><<<grid, kStepThreads, 0, s>>>(ctx, counters, known, B, k, ref_k,
                                                         bf_packed, word_base, n_words,
                                                         kmap_keys, state, counts_len, n_buckets,
                                                         bucket_base, n_local, size_bits);
  });
}

}  // namespace

extern "C" {

// The ring carries a lane's index as 32 bits: B < 2^32.
int malva_shard_update(const void* ctx, const void* counters, const void* known, int64_t B,
                       int wc, int k, int ref_k, const void* bf_packed, int64_t word_base,
                       int64_t n_words, const void* kmap_keys, void* state, int64_t counts_len,
                       int64_t n_buckets, int64_t size_bits, int minifilter, void* ev_start,
                       void* ev_stop, void* stream) {
  if (B <= 0) return launch_timed(ev_start, ev_stop, (cudaStream_t)stream, [](cudaStream_t) {});
  if (B >= ((int64_t)1 << 32)) return (int)cudaErrorInvalidValue;
  switch (wc) {
#define MALVA_K4_CASE(n)                                                                      \
  case n:                                                                                     \
    return launch_shard<n>((const uint32_t*)ctx, (const uint32_t*)counters,                   \
                           (const uint8_t*)known, B, k, ref_k, (const uint2*)bf_packed,       \
                           word_base, n_words, (const uint32_t*)kmap_keys, (uint32_t*)state,  \
                           counts_len, (uint64_t)n_buckets, (uint64_t)size_bits, minifilter,  \
                           ev_start, ev_stop, (cudaStream_t)stream);
    MALVA_WORD_COUNTS(MALVA_K4_CASE)
#undef MALVA_K4_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K5 over the whole gathered batch on one shard; B < 2^32 as for K4.
int malva_gather_update(const void* ctx, const void* counters, const void* known, int64_t B,
                        int wc, int k, int ref_k, const void* bf_packed, int64_t word_base,
                        int64_t n_words, const void* kmap_keys, void* state, int64_t counts_len,
                        int64_t n_buckets, int64_t bucket_base, int64_t n_local,
                        int64_t size_bits, void* ev_start, void* ev_stop, void* stream) {
  if (B <= 0) return launch_timed(ev_start, ev_stop, (cudaStream_t)stream, [](cudaStream_t) {});
  if (B >= ((int64_t)1 << 32)) return (int)cudaErrorInvalidValue;
  switch (wc) {
#define MALVA_K5_CASE(n)                                                                        \
  case n:                                                                                       \
    return launch_gather<n>((const uint32_t*)ctx, (const uint32_t*)counters,                    \
                            (const uint8_t*)known, B, k, ref_k, (const uint2*)bf_packed,        \
                            word_base, n_words, (const uint32_t*)kmap_keys, (uint32_t*)state,   \
                            counts_len, (uint64_t)n_buckets, (uint64_t)bucket_base,             \
                            (uint64_t)n_local, (uint64_t)size_bits, ev_start, ev_stop,          \
                            (cudaStream_t)stream);
    MALVA_WORD_COUNTS(MALVA_K5_CASE)
#undef MALVA_K5_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
