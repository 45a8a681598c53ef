// K6 and K7: the two partition kernels of the routed sharded call step, and
// the launcher of the step's card-to-card copies.
//
// No Pallas counterpart.  They replace pack_dests (malva_tpu/parallel/
// sharded_index.py:326-347, a sort by owner into a (D * cap) slot matrix
// with an overflow flag) and the hop-1 owner's context-filter test (:383-
// 394) of make_routed_call_step, which feed two all_to_alls.  On a GPU the
// hops are fixed-size card-to-card copies, so the sizes are known when the
// copies are issued and a step needs no host read.
//
// A slot block holds the rows a source sends to one destination in a hop,
// in the format launch.cuh defines (kSlotHead, kHop1Cols, kHop2Cols); K4's
// slot entry (shard_step.cu) reads hop 2's.  Rows keep their lane order
// within a destination, as pack_dests' stable sort does, so the slots are
// deterministic; a lane whose rank reaches cap is appended instead to the
// source card's overflow list ([contexts (ovf_cap x N) | counters
// (ovf_cap)], by atomic add on tally[0]), which the session reruns once,
// at its end.  Counter adds commute, so the state does not depend on
// either order.
//
// Each kernel is two launches.  The count pass gives each tile of the
// launch's lanes (kTileRounds blocks of lanes) its count per destination
// (warp-aggregated shared atomics).  The scatter pass gives each tile its
// base per destination by summing the counts of the tiles before it (the
// whole block reads them, at most kMaxTiles x D words), ranks its lanes in
// rounds of one block of lanes (__match_any_sync within a warp, an
// exclusive scan over the warps), and writes each lane's row to its
// destination's block at base + rank, or to the overflow list; its last
// tile writes every destination's header (min(total, cap)) and adds it to
// the tally, from which the session's rows per hop are summed at its end.
// Small tiles keep many blocks in flight: the writes are scattered and
// each round waits on its reads.
//
// Bound: bytes.  K6 reads the hash planes, contexts and counters of its
// lanes (16 + 4N + 4 bytes each, the count pass 12 of them again) and
// writes one row of 4 (N + 4) bytes; K7 reads the received rows, one
// random context-filter word per row, and writes rows of 4 (N + 2) bytes.
// The rows are scattered at most D ways, so the writes stay in few open
// lines; chip_smoke.py counts the bytes and times both beside that bound.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "launch.cuh"
#include "xxh3.cuh"

using namespace malva;

namespace {

constexpr int kRouteThreads = 256;
constexpr int kRouteWarps = kRouteThreads / 32;
constexpr int kMaxDests = 16;    // shards of a mesh
constexpr int kTileRounds = 4;   // rounds of kRouteThreads lanes a tile, where tiles are few
constexpr int kMaxTiles = 8192;  // tiles of a launch (a tile sums the counts before it)

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

// K6's lanes: a source slice.  Lane i (counter != 0) goes to the owner of
// its context word.
struct PackLanes {
  const uint32_t* __restrict__ hx;   // K1 hash-only planes: ctx hi, lo, centre hi, lo (B each)
  const uint32_t* __restrict__ ctx;  // (B, N)
  const uint32_t* __restrict__ cnt;  // (B,)
  int64_t B, wps;
  uint64_t size_bits;
  int N;

  __device__ void prepare(uint32_t*, int) const {}
  __device__ __forceinline__ uint64_t context_index(int64_t i) const {
    return bloom_index((uint64_t)__ldg(hx + i) << 32 | __ldg(hx + B + i), size_bits);
  }
  __device__ __forceinline__ int dest(int64_t i, const uint32_t*, int D) const {
    if (__ldg(cnt + i) == 0) return D;
    return (int)((int64_t)(context_index(i) >> 5) / wps);
  }
  // Row r of block blk (cap rows), from lane i going to d.
  __device__ __forceinline__ void write(int64_t i, const uint32_t*, int d, uint32_t* blk,
                                        int64_t cap, int64_t r) const {
    const uint64_t x = context_index(i);
    const uint64_t c = bloom_index((uint64_t)__ldg(hx + 2 * B + i) << 32 | __ldg(hx + 3 * B + i),
                                   size_bits);
    uint32_t* row = blk + kSlotHead;
    for (int j = 0; j < N; ++j) row[r * N + j] = __ldg(ctx + i * N + j);
    row += cap * N;
    row[r] = __ldg(cnt + i);
    row[cap + r] = (uint32_t)((int64_t)(x >> 5) - (int64_t)d * wps);
    row[2 * cap + r] = (uint32_t)(x & 31);
    row[3 * cap + r] = (uint32_t)((int64_t)(c >> 5) / wps);
  }
  __device__ __forceinline__ void spill(int64_t i, const uint32_t*, uint32_t* ovf, int64_t ovf_cap,
                                        int64_t q) const {
    for (int j = 0; j < N; ++j) ovf[q * N + j] = __ldg(ctx + i * N + j);
    ovf[ovf_cap * N + q] = __ldg(cnt + i);
  }
};

// K7's lanes: the D received hop-1 blocks of cap_in rows, lane i row
// i % cap_in of block i / cap_in, live below the block's header count.  A
// live row goes to the owner of its Bloom word with its context-filter bit.
struct ProbeLanes {
  const uint32_t* __restrict__ in;         // D blocks of kSlotHead + cap_in (N + kHop1Cols)
  const uint32_t* __restrict__ ctx_words;  // the shard's context words
  int64_t cap_in;
  int N;

  __device__ __forceinline__ int64_t block_words() const {
    return kSlotHead + cap_in * (N + kHop1Cols);
  }
  __device__ void prepare(uint32_t* head, int D) const {
    if (threadIdx.x < D) head[threadIdx.x] = __ldg(in + threadIdx.x * block_words());
  }
  __device__ __forceinline__ const uint32_t* row_of(int64_t i, int64_t& r) const {
    const int64_t b = i / cap_in;
    r = i - b * cap_in;
    return in + b * block_words() + kSlotHead;
  }
  __device__ __forceinline__ int dest(int64_t i, const uint32_t* head, int D) const {
    int64_t r;
    const uint32_t* p = row_of(i, r);
    if (r >= head[i / cap_in]) return D;
    return (int)__ldg(p + cap_in * (N + 3) + r);
  }
  __device__ __forceinline__ void write(int64_t i, const uint32_t*, int, uint32_t* blk,
                                        int64_t cap, int64_t rr) const {
    int64_t r;
    const uint32_t* p = row_of(i, r);
    const uint32_t lcw = __ldg(p + cap_in * (N + 1) + r), cb = __ldg(p + cap_in * (N + 2) + r);
    const uint32_t known = (__ldg(ctx_words + lcw) >> cb) & 1u;
    uint32_t* row = blk + kSlotHead;
    for (int j = 0; j < N; ++j) row[rr * N + j] = __ldg(p + r * N + j);
    row += cap * N;
    row[rr] = __ldg(p + cap_in * N + r);
    row[cap + rr] = known;
  }
  __device__ __forceinline__ void spill(int64_t i, const uint32_t*, uint32_t* ovf, int64_t ovf_cap,
                                        int64_t q) const {
    int64_t r;
    const uint32_t* p = row_of(i, r);
    for (int j = 0; j < N; ++j) ovf[q * N + j] = __ldg(p + r * N + j);
    ovf[ovf_cap * N + q] = __ldg(p + cap_in * N + r);
  }
};

// Tile t's lanes: [t * tile, min((t + 1) * tile, n)).
template <class Src>
__global__ void __launch_bounds__(kRouteThreads)
    route_count_kernel(Src src, int64_t n, int64_t tile, int D, uint32_t* __restrict__ counts) {
  __shared__ uint32_t hist[kMaxDests];
  __shared__ uint32_t head[kMaxDests];
  if (threadIdx.x < kMaxDests) hist[threadIdx.x] = 0;
  src.prepare(head, D);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t first = (int64_t)blockIdx.x * tile;
  const int64_t last = first + tile < n ? first + tile : n;
  for (int64_t at = first; at < last; at += kRouteThreads) {
    const int64_t i = at + threadIdx.x;
    const int d = i < last ? src.dest(i, head, D) : D;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    if (d < D && lane == __ffs(peers) - 1) atomicAdd(&hist[d], (uint32_t)__popc(peers));
  }
  __syncthreads();
  if (threadIdx.x < D) counts[(int64_t)blockIdx.x * D + threadIdx.x] = hist[threadIdx.x];
}

template <class Src>
__global__ void __launch_bounds__(kRouteThreads)
    route_scatter_kernel(Src src, int64_t n, int64_t tile, int D, const uint32_t* __restrict__ counts,
                         Blocks out, int64_t cap, uint32_t* __restrict__ ovf, int64_t ovf_cap,
                         unsigned long long* __restrict__ tally, int tally_at) {
  __shared__ uint32_t head[kMaxDests];
  __shared__ uint32_t base[kMaxDests];                // next position of each destination
  __shared__ uint32_t wbase[kRouteWarps][kMaxDests];  // a round's count, then base, per warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  src.prepare(head, D);
  if (threadIdx.x < kMaxDests) base[threadIdx.x] = 0;
  __syncthreads();
  {  // the counts of the tiles before this one, [t][d] flattened, by the whole block
    const int used = kRouteThreads / D * D;  // thread q sums destination q % D
    uint32_t sum = 0;
    if (threadIdx.x < used)
      for (int64_t f = threadIdx.x; f < (int64_t)blockIdx.x * D; f += used) sum += __ldg(counts + f);
    if (sum) atomicAdd(&base[threadIdx.x % D], sum);
  }
  __syncthreads();
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x < D) {  // the last tile: every header and tally
    const uint32_t total = base[threadIdx.x] + __ldg(counts + (int64_t)blockIdx.x * D + threadIdx.x);
    const uint32_t rows = total < cap ? total : (uint32_t)cap;
    out.at(threadIdx.x)[0] = rows;
    atomicAdd(tally + tally_at + threadIdx.x, (unsigned long long)rows);
  }
  const unsigned lt = (1u << lane) - 1u;
  const int64_t first = (int64_t)blockIdx.x * tile;
  const int64_t last = first + tile < n ? first + tile : n;
  for (int64_t at = first; at < last; at += kRouteThreads) {
    for (int q = threadIdx.x; q < kRouteWarps * kMaxDests; q += kRouteThreads)
      wbase[q / kMaxDests][q % kMaxDests] = 0;
    __syncthreads();  // also: head and base are set, the last round has read wbase
    const int64_t i = at + threadIdx.x;
    const int d = i < last ? src.dest(i, head, D) : D;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    if (d < D && lane == __ffs(peers) - 1) wbase[warp][d] = __popc(peers);
    __syncthreads();
    if (threadIdx.x < D) {  // exclusive scan over the warps, in warp (= lane) order
      uint32_t run = base[threadIdx.x];
      for (int w = 0; w < kRouteWarps; ++w) {
        const uint32_t c = wbase[w][threadIdx.x];
        wbase[w][threadIdx.x] = run;
        run += c;
      }
      base[threadIdx.x] = run;
    }
    __syncthreads();
    const int64_t pos = d < D ? (int64_t)wbase[warp][d] + __popc(peers & lt) : 0;
    if (d < D && pos < cap) src.write(i, head, d, out.at(d), cap, pos);
    const bool spills = d < D && pos >= cap;
    const unsigned over = __ballot_sync(0xFFFFFFFFu, spills);
    if (over) {
      unsigned long long at0 = 0;
      if (lane == __ffs(over) - 1) at0 = atomicAdd(tally, (unsigned long long)__popc(over));
      at0 = __shfl_sync(0xFFFFFFFFu, at0, __ffs(over) - 1);
      const int64_t q = (int64_t)at0 + __popc(over & lt);
      if (spills && q < ovf_cap) src.spill(i, head, ovf, ovf_cap, q);
    }
  }
}

// Tiles of kTileRounds blocks of lanes, or more where that would make more
// than kMaxTiles of them.
void tiling(int64_t n, int64_t* tile, int* n_tiles) {
  const int64_t unit = kRouteThreads, most = unit * kMaxTiles;
  const int64_t rounds = (n + most - 1) / most;
  *tile = unit * (rounds > kTileRounds ? rounds : kTileRounds);
  const int64_t t = (n + *tile - 1) / *tile;
  *n_tiles = t > 0 ? (int)t : 1;
}

template <class Src>
int launch_route(const Src& src, int64_t n, int D, uint32_t* counts, void* const* blocks,
                 int64_t cap, uint32_t* ovf, int64_t ovf_cap, unsigned long long* tally,
                 int tally_at, cudaStream_t stream) {
  if (D < 1 || D > kMaxDests || cap < 1) return (int)cudaErrorInvalidValue;
  Blocks out{};
  for (int d = 0; d < D; ++d) out.p[d] = (uint32_t*)blocks[d];
  int64_t tile = 0;
  int n_tiles = 0;
  tiling(n, &tile, &n_tiles);
  route_count_kernel<Src><<<n_tiles, kRouteThreads, 0, stream>>>(src, n, tile, D, counts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  route_scatter_kernel<Src><<<n_tiles, kRouteThreads, 0, stream>>>(
      src, n, tile, D, counts, out, cap, ovf, ovf_cap, tally, tally_at);
  return (int)cudaGetLastError();
}

// The columns of a routed step's plan: one row of int64 per shard, filled
// once by the router (its buffers) and each step (its slice, stream and
// events); pointers as integers; kOut1 and kOut2 begin kMaxDests columns
// each.  This file owns the order: ops/kernels.py reads each column's
// index by its name in kPlanNames (malva_route_plan_col).
enum PlanCol {
  kDev, kHx, kRecv1, kRecv2, kOvf, kOvfCap, kTally, kCounts, kCtxWords, kBfPacked, kNWords,
  kKmapKeys, kState, kCtx, kCounters, kRows, kStream, kEvHash0, kEvHash1, kEvUpd0, kEvUpd1,
  kOut1, kOut2 = kOut1 + kMaxDests, kPlanCols = kOut2 + kMaxDests
};

struct PlanName {
  const char* name;
  int col;
};
constexpr PlanName kPlanNames[] = {
    {"dev", kDev},         {"hx", kHx},                 {"recv1", kRecv1},
    {"recv2", kRecv2},     {"ovf", kOvf},               {"ovf_cap", kOvfCap},
    {"tally", kTally},     {"counts", kCounts},         {"ctx_words", kCtxWords},
    {"bf_packed", kBfPacked}, {"n_words", kNWords},     {"kmap_keys", kKmapKeys},
    {"state", kState},     {"ctx", kCtx},               {"counters", kCounters},
    {"rows", kRows},       {"stream", kStream},         {"ev_hash0", kEvHash0},
    {"ev_hash1", kEvHash1}, {"ev_upd0", kEvUpd0},       {"ev_upd1", kEvUpd1},
    {"out1", kOut1},       {"out2", kOut2},             {"width", kPlanCols},
    {"max_dests", kMaxDests}};

}  // namespace

extern "C" {

// K1's hash-only launcher (callstep.cu) and K4's slot entry (shard_step.cu).
int malva_callstep_hash(const void* ctx, int64_t B, int wc, int k, int ref_k, int with_ctx,
                        void* out, void* ev_start, void* ev_stop, void* stream);
int malva_shard_update_slots(const void* slots, int64_t n_blocks, int64_t cap, int wc, int k,
                             int ref_k, const void* bf_packed, int64_t word_base, int64_t n_words,
                             const void* kmap_keys, void* state, int64_t counts_len,
                             int64_t n_buckets, int64_t size_bits, int minifilter,
                             void* ev_start, void* ev_stop, void* stream);
int malva_route_pack(const void* hx, const void* ctx, const void* counters, int64_t B, int wc,
                     int64_t size_bits, int64_t wps, int D, void* const* blocks, int64_t cap,
                     void* ovf, int64_t ovf_cap, void* tally, void* counts, void* stream);
int malva_route_probe(const void* in, int64_t cap_in, int wc, const void* ctx_words, int D,
                      void* const* blocks, int64_t cap, void* ovf, int64_t ovf_cap, void* tally,
                      void* counts, void* stream);
int malva_route_copies(int D, const int* dev, void* const* compute, void* const* produced,
                       void* const* guard, int n, const int* from, const int* to,
                       void* const* dst, void* const* src, int64_t bytes,
                       void* const* streams, void* const* copied);

// The plan column (PlanCol) of `name`, "width" for the row's width and
// "max_dests" for the columns after kOut1 and kOut2; -1 for another name.
int malva_route_plan_col(const char* name) {
  for (const PlanName& p : kPlanNames)
    if (strcmp(p.name, name) == 0) return p.col;
  return -1;
}

// The slot block's format (launch.cuh): what 0 asks for kSlotHead, 1 for
// kHop1Cols, 2 for kHop2Cols; -1 for another.
int malva_slot_layout(int what) {
  return what == 0 ? (int)kSlotHead : what == 1 ? kHop1Cols : what == 2 ? kHop2Cols : -1;
}

// The largest number of tiles a launch uses: the `counts` scratch holds
// route_max_tiles() * D words.
int malva_route_max_tiles() { return kMaxTiles; }

// K6 over the B lanes of a source slice: `hx` K1 hash-only's planes (with
// the context hash), `ctx` (B, wc) packed contexts, `counters` (B,); each
// lane with a counter goes to destination cw / wps, into blocks[d] (cap rows
// of hop 1 each), or to the overflow list; the tally gets the overflow at
// [0] and the rows sent to d at [1 + d].
int malva_route_pack(const void* hx, const void* ctx, const void* counters, int64_t B, int wc,
                     int64_t size_bits, int64_t wps, int D, void* const* blocks, int64_t cap,
                     void* ovf, int64_t ovf_cap, void* tally, void* counts, void* stream) {
  if (wc < 1 || wps < 1) return (int)cudaErrorInvalidValue;
  const PackLanes src{(const uint32_t*)hx, (const uint32_t*)ctx, (const uint32_t*)counters, B,
                      wps, (uint64_t)size_bits, wc};
  return launch_route(src, B, D, (uint32_t*)counts, blocks, cap, (uint32_t*)ovf, ovf_cap,
                      (unsigned long long*)tally, 1, (cudaStream_t)stream);
}

// K7 over the D received hop-1 blocks `in` (cap_in rows each) of one shard
// with context words `ctx_words`: each live row goes to its Bloom-word
// owner, into blocks[d] (cap rows of hop 2 each), with its context-filter
// bit, or to the overflow list; the tally gets the rows sent to d at
// [1 + D + d].
int malva_route_probe(const void* in, int64_t cap_in, int wc, const void* ctx_words, int D,
                      void* const* blocks, int64_t cap, void* ovf, int64_t ovf_cap, void* tally,
                      void* counts, void* stream) {
  if (wc < 1 || cap_in < 1) return (int)cudaErrorInvalidValue;
  const ProbeLanes src{(const uint32_t*)in, (const uint32_t*)ctx_words, cap_in, wc};
  return launch_route(src, (int64_t)D * cap_in, D, (uint32_t*)counts, blocks, cap,
                      (uint32_t*)ovf, ovf_cap, (unsigned long long*)tally, 1 + D,
                      (cudaStream_t)stream);
}

// Peer access from card `dev` to card `peer`, where the pair can have it,
// so that their copies go card to card without the driver staging them;
// enabling it again is no error.  Returns the first CUDA error, or 0.
int malva_enable_peer(int dev, int peer) {
  int cur = 0, can = 0;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess) e = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (e == cudaSuccess && can) {
    e = cudaSetDevice(dev);
    if (e == cudaSuccess) e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      (void)cudaGetLastError();
      e = cudaSuccess;
    }
  }
  const cudaError_t r = cudaSetDevice(cur);
  return (int)(e != cudaSuccess ? e : r);
}

// One hop's card-to-card copies.  Card s's compute stream compute[s] (on
// card dev[s]) records produced[s]: its blocks are written.  Copy i sends
// `bytes` from src[i] on card dev[from[i]] to dst[i] on card dev[to[i]] on
// a stream of its own, streams[i] (of card dev[from[i]]), after
// produced[from[i]] and, where given, guard[to[i]] (the destination is done
// with the previous contents), and records copied[i]; then the compute
// streams of both ends wait for copied[i], so that no kernel reads a block
// before it lands or writes a source block before it has left.  No host
// wait.  Returns the first CUDA error, or 0.
int malva_route_copies(int D, const int* dev, void* const* compute, void* const* produced,
                       void* const* guard, int n, const int* from, const int* to,
                       void* const* dst, void* const* src, int64_t bytes,
                       void* const* streams, void* const* copied) {
  int cur = 0;
  cudaError_t e = cudaGetDevice(&cur);
  for (int s = 0; s < D && e == cudaSuccess; ++s) {
    e = cudaSetDevice(dev[s]);
    if (e == cudaSuccess) e = cudaEventRecord((cudaEvent_t)produced[s], (cudaStream_t)compute[s]);
  }
  for (int i = 0; i < n && e == cudaSuccess; ++i) {
    const cudaStream_t st = (cudaStream_t)streams[i];
    e = cudaSetDevice(dev[from[i]]);
    if (e == cudaSuccess) e = cudaStreamWaitEvent(st, (cudaEvent_t)produced[from[i]], 0);
    if (e == cudaSuccess && guard) e = cudaStreamWaitEvent(st, (cudaEvent_t)guard[to[i]], 0);
    if (e == cudaSuccess)
      e = cudaMemcpyPeerAsync(dst[i], dev[to[i]], src[i], dev[from[i]], (size_t)bytes, st);
    if (e == cudaSuccess) e = cudaEventRecord((cudaEvent_t)copied[i], st);
  }
  for (int i = 0; i < 2 * n && e == cudaSuccess; ++i) {
    const int end = i < n ? to[i] : from[i - n];
    e = cudaSetDevice(dev[end]);
    if (e == cudaSuccess)
      e = cudaStreamWaitEvent((cudaStream_t)compute[end], (cudaEvent_t)copied[i % n], 0);
  }
  const cudaError_t r = cudaSetDevice(cur);
  return (int)(e != cudaSuccess ? e : r);
}

// One routed step over the D shards of `plan` (PlanCol), in one call, so
// that the host issues a step at the cost of one: on each source, K1
// hash-only and K6; hop 1's copies (malva_route_copies, where n pairs
// cross cards; produced1/2 and copied1/2 are the hops' events); on each
// owner, K7; hop 2's copies; on each owner, K4's slot entry, its Bloom
// words starting at d * wps.  Returns the first CUDA error, or 0.
int malva_routed_step(int D, const int64_t* plan, int wc, int k, int ref_k, int minifilter,
                      int64_t cap, int64_t size_bits, int64_t wps, int64_t n_buckets,
                      int64_t counts_len, int n, const int* dev, const int* from, const int* to,
                      void* const* streams, void* const* produced1, void* const* produced2,
                      void* const* copied1, void* const* copied2, void* const* dst1,
                      void* const* src1, void* const* dst2, void* const* src2, int64_t bytes1,
                      int64_t bytes2) {
  if (D < 1 || D > kMaxDests) return (int)cudaErrorInvalidValue;
  auto at = [&](int s, int c) { return plan[(int64_t)s * kPlanCols + c]; };
  auto ptr = [&](int s, int c) { return (void*)at(s, c); };
  auto blocks = [&](int s, int c) { return (void* const*)(plan + (int64_t)s * kPlanCols + c); };
  int cur = 0;
  int e = (int)cudaGetDevice(&cur);
  void* compute[kMaxDests];
  for (int s = 0; s < D; ++s) compute[s] = ptr(s, kStream);
  for (int s = 0; s < D && !e; ++s) {
    e = (int)cudaSetDevice((int)at(s, kDev));
    if (!e)
      e = malva_callstep_hash(ptr(s, kCtx), at(s, kRows), wc, k, ref_k, 1, ptr(s, kHx),
                              ptr(s, kEvHash0), ptr(s, kEvHash1), compute[s]);
    if (!e)
      e = malva_route_pack(ptr(s, kHx), ptr(s, kCtx), ptr(s, kCounters), at(s, kRows), wc,
                           size_bits, wps, D, blocks(s, kOut1), cap, ptr(s, kOvf),
                           at(s, kOvfCap), ptr(s, kTally), ptr(s, kCounts), compute[s]);
  }
  if (!e && n)
    e = malva_route_copies(D, dev, compute, produced1, produced2, n, from, to, dst1, src1,
                           bytes1, streams, copied1);
  for (int d = 0; d < D && !e; ++d) {
    e = (int)cudaSetDevice((int)at(d, kDev));
    if (!e)
      e = malva_route_probe(ptr(d, kRecv1), cap, wc, ptr(d, kCtxWords), D, blocks(d, kOut2),
                            cap, ptr(d, kOvf), at(d, kOvfCap), ptr(d, kTally), ptr(d, kCounts),
                            compute[d]);
  }
  if (!e && n)
    e = malva_route_copies(D, dev, compute, produced2, produced1, n, from, to, dst2, src2,
                           bytes2, streams, copied2);
  for (int d = 0; d < D && !e; ++d) {
    e = (int)cudaSetDevice((int)at(d, kDev));
    if (!e)
      e = malva_shard_update_slots(ptr(d, kRecv2), D, cap, wc, k, ref_k, ptr(d, kBfPacked),
                                   (int64_t)d * wps, at(d, kNWords), ptr(d, kKmapKeys),
                                   ptr(d, kState), counts_len, n_buckets, size_bits, minifilter,
                                   ptr(d, kEvUpd0), ptr(d, kEvUpd1), compute[d]);
  }
  const int r = (int)cudaSetDevice(cur);
  return e ? e : r;
}

}  // extern "C"
