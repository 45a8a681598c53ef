// The device half of the partitions into slot blocks that K6 and K7
// (route.cu) and K8 (ref_scan.cu's pack mode) share: the destinations'
// blocks as a kernel parameter, a tile's statuses published and read with
// relaxed 64-bit accesses, and warp 0's look-back for the tile's bases
// (route.cuh holds the logic the g++ tests run).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "route.cuh"

namespace malva {

struct Blocks {
  uint32_t* p[kMaxDests];  // the destinations' blocks

  // p[d] by an unrolled select: an index at run time into a kernel
  // parameter would copy the array to local memory.
  __device__ __forceinline__ uint32_t* at(int d) const {
    uint32_t* r = p[0];
#pragma unroll
    for (int j = 1; j < kMaxDests; ++j) r = j == d ? p[j] : r;
    return r;
  }
};

// A tile publishes a status with a relaxed store: the word carries its
// count itself, and no reader reads anything else the tile wrote, so a
// release would only wait for the tile's earlier memory operations.
__device__ __forceinline__ void publish(unsigned long long* p, uint64_t status) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"((unsigned long long)status)
               : "memory");
}

// A look-back step reads its window with relaxed loads, all in flight at
// once.  Nothing it reads depends on another tile's other writes, so no
// acquire is needed: each load would wait for the one before, and a fence
// after them for the tile's context copies issued just before.
__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// What warp 0 of a tile hands the block.
struct TileShared {
  uint32_t woff[kRouteWarps][kMaxDests];  // the warps' counts, then their staged offsets
  DestRun run[kMaxDests];
  uint32_t heads[kMaxDests];       // the rows of each input block, where it has a header
  uint32_t start[kMaxDests + 1];   // the first lane of each
  int64_t tile;
  int last_done;
};

// Warp 0: the look-back for the tile's base per destination (lanes (j, e)
// of route.cuh's window, kLook statuses a lane a step), its inclusive
// prefixes published, the rows of each destination that go to the block
// and to the overflow list (one atomic add a tile), and in the last tile
// each block's header and tally.
template <int kLook = kLookBack>
__device__ void tile_bases(TileShared& sh, int64_t t, int64_t last, int D, const Blocks& out,
                           int64_t cap, unsigned long long* __restrict__ tally, int tally_at,
                           unsigned long long* __restrict__ status) {
  const int lane = threadIdx.x & 31, lanes = dest_lanes(D), rows = 32 / lanes;
  const int e = lane & (lanes - 1), j = lane / lanes;
  uint32_t base = 0;
  bool done = t == 0 || e >= D;
  int64_t next = t - 1;  // the nearest tile not yet taken
  while (__any_sync(~0u, !done)) {
    uint64_t w[kLook];
#pragma unroll
    for (int k = 0; k < kLook; ++k) {
      const int64_t at = next - j - rows * k;
      w[k] = !done && at >= 0 ? ld_relaxed(status + at * D + e) : 0;
    }
    int stop = lane_stop(w, j, rows);
    for (int m = lanes; m < 32; m *= 2) stop = min(stop, __shfl_xor_sync(~0u, stop, m));
    uint32_t sum = lane_sum(w, j, rows, stop);
    int found = lane_prefix_at(w, j, rows, stop);
    for (int m = lanes; m < 32; m *= 2) {
      sum += __shfl_xor_sync(~0u, sum, m);
      found |= __shfl_xor_sync(~0u, found, m);
    }
    if (!done) {
      base += sum;
      next -= stop + found;
      done = found;
      if (stop + found == 0) __nanosleep(64);
    }
  }
  DestRun& r = sh.run[lane & (kMaxDests - 1)];
  if (lane < D) {  // lane e, row 0
    if (t > 0) publish(status + t * D + lane, status_word(kStatusPrefix, base + r.tot));
    set_base(r, base, cap);
  }
  __syncwarp();
  const uint32_t all = __reduce_add_sync(~0u, lane < D ? r.over : 0u);
  unsigned long long q0 = 0;
  if (lane == 0 && all) q0 = atomicAdd(tally, (unsigned long long)all);
  q0 = __shfl_sync(~0u, q0, 0);
  if (lane < D) {
    r.ovf_at = (int64_t)q0 + tot_before(sh.run, lane, true);
    if (t == last) {
      const int64_t total = (int64_t)r.base + r.tot;
      const uint32_t rows_in = (uint32_t)(total < cap ? total : cap);
      out.at(lane)[0] = rows_in;
      atomicAdd(tally + tally_at + lane, (unsigned long long)rows_in);
    }
  }
}

}  // namespace malva
