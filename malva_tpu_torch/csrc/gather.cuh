// K5's lane logic (shard_step.cu gather_update_kernel), header-only and
// __host__ __device__, so that a host build can emulate a launch
// (tests/test_torch_gather_tiles.py) and the per-lane path
// (tests/test_torch_lanes.py) bit for bit against the plain version.
//
// K5 takes its lanes as K1 hash-only left them (callstep.cu, the planes
// [c_hi, c_lo, can_0 .. can_{w_k-1}] of the gathered batch), so it hashes
// nothing.  From a lane's centre hash, gather_lane says what the lane has
// to do on this shard: its Bloom word may be the shard's ("owned": a row
// to gather, and its counter to add where the bit is set and the context
// is not known), and one or both of its two global buckets may be the
// shard's ("candidate": a probe, gated neither by the bit nor by the
// flag).  A warp's ballots then put each kind into a dense queue of its own
// in shared memory (enqueue), and a pass takes one owned lane and one
// candidate a thread: the row's 8 bytes, the candidate's key words and the
// 16-byte words of both its buckets are all loaded before any is used
// (load_bucket), so a probe never waits behind a row gather, nor bucket 2
// behind bucket 1; then the counter add (gather_counter) and the probe
// (probe_pair: bucket 1 before bucket 2, the lowest slot first, as
// kmap_table.py probe_bucket_table).
#pragma once

#include "lanes.cuh"

namespace malva {

constexpr uint32_t kNoBucket = 0xFFFFFFFFu;  // a bucket that is not the shard's
constexpr int kGatherLanes = 2;                // lanes a thread classifies a tile
constexpr int kGatherTile = 32 * kGatherLanes;  // lanes a warp classifies a tile
constexpr int kGatherRing = 128;  // entries a queue: 31 left over + a tile's, a power of two

// What lane of centre hash c has to do on a shard that holds Bloom words
// word_base .. + n_words - 1 and buckets bucket_base .. + n_local - 1 of
// the global table of n_buckets (`skip`, for timing only: bit 0 leaves
// the probe out, bit 1 the row).
struct GatherLane {
  bool owned, cand;
  uint32_t row, bit;  // the Bloom row less the shard's first, the bit in its word
  uint32_t lb[2];     // the two buckets less the shard's first, or kNoBucket
};

MALVA_HD GatherLane gather_lane(uint64_t c, uint64_t size_bits, int64_t word_base,
                                int64_t n_words, uint64_t n_buckets, uint64_t bucket_base,
                                uint64_t n_local, uint32_t skip) {
  GatherLane g;
  const uint64_t idx = bloom_index(c, size_bits);
  const int64_t lw = (int64_t)(idx >> 5) - word_base;
  g.owned = !(skip & 2u) && lw >= 0 && lw < n_words;
  g.row = (uint32_t)lw;
  g.bit = (uint32_t)(idx & 31);
  uint32_t b[2];
  bucket_pair(c, n_buckets, b);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const uint64_t l = (uint64_t)b[t] - bucket_base;
    g.lb[t] = !(skip & 1u) && l < n_local ? (uint32_t)l : kNoBucket;
  }
  g.cand = g.lb[0] != kNoBucket || g.lb[1] != kNoBucket;
  return g;
}

// A warp's two queues, rings of kGatherRing entries, one array per field
// so that the lanes of a pass read distinct banks: the owned lanes (row,
// bit | known << 5, counter) and the candidates (the two buckets, counter,
// lane index, for the key words).
struct GatherQueues {
  uint32_t row[kGatherRing], bk[kGatherRing], rcnt[kGatherRing];
  uint32_t lb1[kGatherRing], lb2[kGatherRing], pcnt[kGatherRing], lane[kGatherRing];
};

// Lane `lane` of a warp (lane i of the batch, counter cnt, merged flag
// known) into the queues, from the warp's ballots of owned lanes and of
// candidates: each queue stays dense and in lane order, from its tail
// (head + entries queued).
MALVA_HD void enqueue(GatherQueues& q, const GatherLane& g, uint32_t cnt, bool known, uint32_t i,
                      uint32_t owned_ballot, uint32_t cand_ballot, int lane, uint32_t row_tail,
                      uint32_t cand_tail) {
  const uint32_t below = (1u << lane) - 1u;
  if (g.owned) {
    const uint32_t e = (row_tail + popc32(owned_ballot & below)) & (kGatherRing - 1);
    q.row[e] = g.row;
    q.bk[e] = g.bit | (uint32_t)known << 5;
    q.rcnt[e] = cnt;
  }
  if (g.cand) {
    const uint32_t e = (cand_tail + popc32(cand_ballot & below)) & (kGatherRing - 1);
    q.lb1[e] = g.lb[0];
    q.lb2[e] = g.lb[1];
    q.pcnt[e] = cnt;
    q.lane[e] = i;
  }
}

// The counter index of an owned lane's Bloom bit in its [word, rank] row
// (no mini-filter), or -1 where the bit is clear or the context is known
// (bk: bit | known << 5).
MALVA_HD int64_t gather_counter(uint32_t word, uint32_t rank, uint32_t bk) {
  const uint32_t bit = bk & 31u;
  if (!((word >> bit) & 1u) || (bk >> 5)) return -1;
  return (int64_t)rank + popc32(word & ((1u << bit) - 1u));
}

// The kSlots * WK key words of local bucket lb (zeros for kNoBucket): on
// the card WK 16-byte loads, the table being 16-byte aligned (a bucket is
// 16 WK bytes).
template <int WK>
MALVA_HD void load_bucket(const uint32_t* keys, uint32_t lb, uint32_t (&w)[kSlots * WK]) {
#ifdef __CUDA_ARCH__
  const uint4* p = reinterpret_cast<const uint4*>(keys) + (uint64_t)lb * WK;
#pragma unroll
  for (int q = 0; q < WK; ++q) {
    const uint4 v = lb != kNoBucket ? __ldg(p + q) : make_uint4(0u, 0u, 0u, 0u);
    w[4 * q] = v.x;
    w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
#else
  for (int x = 0; x < kSlots * WK; ++x)
    w[x] = lb != kNoBucket ? keys[(uint64_t)lb * kSlots * WK + x] : 0u;
#endif
}

// The slot, relative to the shard's first bucket, of the key `can` in its
// buckets lb[0] and lb[1] (words w[0] and w[1]), or -1: bucket 1 before
// bucket 2, the lowest slot first; a bucket that is not the shard's never
// matches.
template <int WK>
MALVA_HD int64_t probe_pair(const uint32_t (&w)[2][kSlots * WK], const uint32_t (&can)[WK],
                            const uint32_t (&lb)[2]) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    int hit = -1;
#pragma unroll
    for (int s = kSlots - 1; s >= 0; --s) {  // the lowest matching slot is taken last
      bool eq = true;
#pragma unroll
      for (int j = 0; j < WK; ++j) eq = eq & (w[t][s * WK + j] == can[j]);
      hit = eq ? s : hit;
    }
    if (lb[t] != kNoBucket && hit >= 0) return (int64_t)lb[t] * kSlots + hit;
  }
  return -1;
}

}  // namespace malva
