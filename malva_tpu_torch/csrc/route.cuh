// The tile logic of K6 and K7 (route.cu), of K8's partition (ref_scan.cu's
// pack mode) and the live-row map of K7 and K4's slot entry (shard_step.cu),
// header-only and __host__ __device__, so that a host build runs the same
// code (the g++ tests of tests/test_torch_route_tiles.py emulate a launch
// with it, the warp intrinsics done serially).  What stays in the kernels'
// sources and partition.cuh is what only a card has: ballots and shuffles,
// shared memory, cp.async, atomics and the statuses' 64-bit loads and
// stores.
//
// A launch cuts its lanes into tiles of kTileLanes.  A tile takes its index
// from a ticket, ranks its lanes by destination, publishes its count per
// destination, looks back over the tiles before it for its bases (decoupled
// look-back: Merrill and Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", NVIDIA 2016), stages its rows grouped by
// destination and writes each destination's rows as runs.
//
// Lanes sit in registers warp-striped: thread `lane` of warp w holds item i
// = tile lane w * 32 * kRouteItems + i * 32 + lane, so that each load of an
// item is coalesced, and (warp, item, lane) order is lane order.
#pragma once

#include <stdint.h>

#include "xxh3.cuh"

namespace malva {

constexpr int kMaxDests = 16;                // shards of a mesh
constexpr int kDestBits = 4;                 // bits of a destination
constexpr int kMaxWords = 15;                // context words of a row (ref_k <= 240)
constexpr int kRouteThreads = 256;
constexpr int kRouteWarps = kRouteThreads / 32;
constexpr int kRouteItems = 8;               // lanes a thread holds
constexpr int kTileLanes = kRouteThreads * kRouteItems;
constexpr int kMaxTiles = 1 << 16;           // tiles of a launch: 2^27 lanes
constexpr int kLookBack = 16;                // statuses a lane reads in a look-back step
constexpr int kScratchHead = 2;              // scratch: [ticket, tiles done, statuses]

MALVA_HD uint32_t load_ro(const uint32_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// Tile lane of (warp, item, lane).
MALVA_HD int item_lane(int warp, int item, int lane) {
  return (warp * kRouteItems + item) * 32 + lane;
}

// Bits of a destination below D, and the lanes of a destination's column
// of a look-back window: D rounded up to a power of two.
MALVA_HD int dest_bits(int D) {
  int b = 0;
  while ((1 << b) < D) ++b;
  return b;
}

MALVA_HD int dest_lanes(int D) { return 1 << dest_bits(D); }

// -- a tile's status per destination, one 64-bit word ------------------------
// The flag in the top two bits (0: not yet published), the count below.

constexpr uint64_t kStatusAggregate = 1, kStatusPrefix = 2;

MALVA_HD uint64_t status_word(uint64_t flag, uint32_t count) { return flag << 62 | count; }
MALVA_HD uint64_t status_flag(uint64_t s) { return s >> 62; }
MALVA_HD uint32_t status_count(uint64_t s) { return (uint32_t)s; }

// A look-back step: the warp reads a window of kLookBack x rows statuses
// of each destination, rows = 32 / dest_lanes(D) tiles a row, lane (j, e)
// = (lane / dest_lanes, lane % dest_lanes) holding in w[k] the status of
// destination e at offset j + rows * k (the tile that many before the
// nearest not yet taken).  The step takes the offsets up to the first
// that is not an aggregate: an inclusive prefix ends the look-back, an
// unpublished status is read again in the next step.

// The first offset of the lane's that holds no aggregate, or the window's
// size.
template <int W>
MALVA_HD int lane_stop(const uint64_t (&w)[W], int j, int rows) {
  int stop = rows * W;
#pragma unroll
  for (int k = W - 1; k >= 0; --k)
    if (status_flag(w[k]) != kStatusAggregate) stop = j + rows * k;
  return stop;
}

// Whether the lane holds an inclusive prefix at offset `stop`.
template <int W>
MALVA_HD bool lane_prefix_at(const uint64_t (&w)[W], int j, int rows, int stop) {
  bool p = false;
#pragma unroll
  for (int k = 0; k < W; ++k)
    p |= j + rows * k == stop && status_flag(w[k]) == kStatusPrefix;
  return p;
}

// The lane's counts at the offsets before `stop` (the warp's first stop),
// and at `stop` where it holds an inclusive prefix there.
template <int W>
MALVA_HD uint32_t lane_sum(const uint64_t (&w)[W], int j, int rows, int stop) {
  uint32_t sum = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int o = j + rows * k;
    if (o < stop || (o == stop && status_flag(w[k]) == kStatusPrefix)) sum += status_count(w[k]);
  }
  return sum;
}

// -- ranking ------------------------------------------------------------------

// The lanes of a warp whose destination is e, from the ballot of the lanes
// with a destination and the ballots of the destinations' low `bits` bits.
MALVA_HD uint32_t dest_mask(uint32_t valid, const uint32_t (&ballot)[kDestBits], int bits,
                            int e) {
  uint32_t m = valid;
#pragma unroll
  for (int b = 0; b < kDestBits; ++b)
    if (b < bits) m &= (e >> b & 1) ? ballot[b] : ~ballot[b];
  return m;
}

// Destination e's column of the warps' counts, made exclusive in warp
// order in place; returns the tile's count for e.
MALVA_HD uint32_t warp_offsets(uint32_t (&wcount)[kRouteWarps][kMaxDests], int e) {
  uint32_t run = 0;
#pragma unroll
  for (int w = 0; w < kRouteWarps; ++w) {
    const uint32_t c = wcount[w][e];
    wcount[w][e] = run;
    run += c;
  }
  return run;
}

// -- the runs a tile writes ------------------------------------------------------
// A tile's tot rows for destination e are staged at [soff, soff + tot), in
// destination order, and have the global ranks base .. base + tot - 1:
// those below cap (slot) go to e's block from row base on, the rest (over)
// to the overflow list from row ovf_at on.

struct DestRun {
  uint32_t tot, soff, base, slot, over;
  int64_t ovf_at;
};

// r[0].tot + ... + r[e - 1].tot (over: the same of .over).
MALVA_HD uint32_t tot_before(const DestRun* r, int e, bool over = false) {
  uint32_t s = 0;
  for (int j = 0; j < e; ++j) s += over ? r[j].over : r[j].tot;
  return s;
}

// r's base, and the rows that go to the block and to the overflow list.
MALVA_HD void set_base(DestRun& r, uint32_t base, int64_t cap) {
  r.base = base;
  r.slot = (int64_t)base >= cap ? 0 : (int64_t)r.tot < cap - base ? r.tot : (uint32_t)(cap - base);
  r.over = r.tot - r.slot;
}

// A tile's staging in shared memory, in words: its rows' contexts (N words
// a row), then C column planes of kTileLanes words, in destination order.
MALVA_HDC int stage_words(int N, int C) { return kTileLanes * (N + C); }

// What a tile writes for a destination: run_kinds(S, O) runs of words from
// its staging (`ctx`, `cols`) to its block's rows (`rows`, past the
// header: the context plane, then S planes of cap) and to the overflow
// list (contexts (ovf_cap x N), then O column planes of ovf_cap); kind:
// the context plane, each of the S slot columns, the overflow contexts,
// each of the O overflow columns.  Both take the first of the staged
// columns.
struct Run {
  uint32_t* dst;
  const uint32_t* src;
  int64_t n;
};

MALVA_HDC int run_kinds(int S, int O) { return S + 2 + O; }

template <int S, int O>
MALVA_HD Run tile_run(int kind, const DestRun& r, uint32_t* rows, const uint32_t* ctx,
                      const uint32_t* cols, int N, int64_t cap, uint32_t* ovf, int64_t ovf_cap) {
  if (kind == 0)
    return {rows + (int64_t)r.base * N, ctx + (int64_t)r.soff * N, (int64_t)r.slot * N};
  if (kind <= S)
    return {rows + cap * (N + kind - 1) + r.base, cols + (kind - 1) * kTileLanes + r.soff,
            r.slot};
  const int64_t room = ovf_cap - r.ovf_at;
  const int64_t n = room < 0 ? 0 : room < r.over ? room : r.over;
  if (kind == S + 1) return {ovf + r.ovf_at * N, ctx + (int64_t)(r.soff + r.slot) * N, n * N};
  const int j = kind - S - 2;
  return {ovf + ovf_cap * (N + j) + r.ovf_at, cols + j * kTileLanes + r.soff + r.slot, n};
}

// n words from src (any alignment) to dst by `width` threads, thread
// `lane` of them: single words up to dst's 16-byte boundary, then 16-byte
// stores, then single words.
MALVA_HD void write_run(uint32_t* dst, const uint32_t* src, int64_t n, int lane, int width) {
  int64_t head = (int64_t)(-(intptr_t)((uintptr_t)dst >> 2) & 3);
  head = head < n ? head : n;
  for (int64_t q = lane; q < head; q += width) dst[q] = src[q];
  const int64_t quads = (n - head) >> 2;
  uint32_t* d4 = dst + head;
  const uint32_t* s4 = src + head;
  for (int64_t q = lane; q < quads; q += width) {
    const uint32_t* s = s4 + 4 * q;
#ifdef __CUDA_ARCH__
    *reinterpret_cast<uint4*>(d4 + 4 * q) = make_uint4(s[0], s[1], s[2], s[3]);
#else
    for (int j = 0; j < 4; ++j) d4[4 * q + j] = s[j];
#endif
  }
  for (int64_t q = head + 4 * quads + lane; q < n; q += width) dst[q] = src[q];
}

// -- the lanes of K6 and K7 -----------------------------------------------------
// A launch numbers its lanes in lane order from 0; tile t holds lanes
// [t * kTileLanes, (t + 1) * kTileLanes), and the tiles past the last that
// holds a lane do nothing (K7's lanes are the live rows alone, so the
// tiles past them read the headers and stop).  Each kind of lanes gives
// the most tiles a launch can need, the rows each input block holds where
// it has a header (read once a tile into shared memory, then `start`, the
// first lane of each block), the launch's lanes, each lane's raw words
// (fetch, then fetch2 for the reads that depend on them, which only the
// columns need), its destination (D for none), its row's further columns
// and its row's context words.

// start[d] = heads[0] + ... + heads[d - 1], for d <= D.
MALVA_HD void block_starts(const uint32_t* heads, int D, uint32_t* start) {
  start[0] = 0;
  for (int d = 0; d < D; ++d) start[d + 1] = start[d] + heads[d];
}

MALVA_HD int64_t last_tile(int64_t lanes) { return lanes > 0 ? (lanes - 1) / kTileLanes : 0; }

MALVA_HD int tile_live(int64_t lanes, int64_t t) {
  const int64_t n = lanes - t * kTileLanes;
  return n < 0 ? 0 : n < kTileLanes ? (int)n : kTileLanes;
}

// -- live rows, block after block (K7 and K4's slot entry) ------------------------
// A launch over received slot blocks takes as its lanes only their live
// rows: block b's first min(header, cap) rows are K7's lanes start[b] ..
// start[b + 1] - 1, with start from block_starts over live_rows; K4's
// slot entry cuts each block's rows into whole tiles, and block b's are
// its tiles first_tile[b] .. first_tile[b + 1] - 1, by the same map.

// The rows a block holds: its header's count, at most cap.
MALVA_HD uint32_t live_rows(uint32_t head, int64_t cap) {
  return (int64_t)head < cap ? head : (uint32_t)cap;
}

// The block that holds lane (or tile) i < start[D]: the number of blocks
// after the first that start at i or before it (an empty block starts
// where the next does, so it is passed over).
MALVA_HD int lane_block(uint32_t i, const uint32_t* start, int D) {
  int b = 0;
#pragma unroll
  for (int d = 1; d < kMaxDests; ++d) b += d < D && i >= start[d];
  return b;
}

// K6's lanes: a source slice of B lanes.  Lane i (counter != 0) goes to
// the owner of its context word, with [counter, context word less the
// owner's first, context bit, Bloom-word owner].
struct PackLanes {
  static constexpr int kCols = 4, kSlotCols = 4, kOvfCols = 1;
  struct Raw {
    uint32_t x_hi, x_lo, c_hi, c_lo, cnt;
  };
  const uint32_t* hx;   // K1 hash-only planes: ctx hi, lo, centre hi, lo (B each)
  const uint32_t* ctx;  // (B, N)
  const uint32_t* cnt;  // (B,)
  int64_t B;
  uint32_t wps;
  uint64_t size_bits;
  int N;

  MALVA_HD int64_t tiles() const { return last_tile(B) + 1; }
  MALVA_HD uint32_t head_rows(int) const { return 0; }
  MALVA_HD int64_t lanes(const uint32_t*) const { return B; }
  MALVA_HD Raw fetch(int64_t i, const uint32_t*) const {
    return {load_ro(hx + i), load_ro(hx + B + i), load_ro(hx + 2 * B + i),
            load_ro(hx + 3 * B + i), load_ro(cnt + i)};
  }
  MALVA_HD void fetch2(Raw&) const {}
  MALVA_HD uint64_t context_index(const Raw& r) const {
    return bloom_index((uint64_t)r.x_hi << 32 | r.x_lo, size_bits);
  }
  MALVA_HD int dest(const Raw& r, int D) const {
    if (r.cnt == 0) return D;
    const uint32_t d = (uint32_t)(context_index(r) >> 5) / wps;
    return d < (uint32_t)D ? (int)d : D;
  }
  MALVA_HD void columns(const Raw& r, int d, uint32_t* col) const {
    const uint64_t x = context_index(r);
    col[0] = r.cnt;
    col[1] = (uint32_t)(x >> 5) - (uint32_t)d * wps;
    col[2] = (uint32_t)(x & 31);
    col[3] = (uint32_t)(bloom_index((uint64_t)r.c_hi << 32 | r.c_lo, size_bits) >> 5) / wps;
  }
  MALVA_HD const uint32_t* ctx_row(int64_t i, const uint32_t*) const { return ctx + i * N; }
};

// K7's lanes: the live rows (below each header's count) of the D received
// hop-1 blocks of cap_in rows (`head` header words, then the context plane
// and the planes of counter, context word, context bit, Bloom-word owner),
// block after block.  A row goes to its Bloom-word owner with [counter,
// context-filter bit].
struct ProbeLanes {
  static constexpr int kCols = 2, kSlotCols = 2, kOvfCols = 1;
  struct Raw {
    uint32_t own, cnt, lcw, cb, word;
  };
  const uint32_t* in;
  const uint32_t* ctx_words;  // the shard's context words
  int64_t cap_in, block_words;
  int head, N, D;

  MALVA_HD int64_t tiles() const { return last_tile(D * cap_in) + 1; }
  MALVA_HD uint32_t head_rows(int d) const {
    return live_rows(load_ro(in + d * block_words), cap_in);
  }
  MALVA_HD int64_t lanes(const uint32_t* start) const { return start[D]; }
  // Lane i's block's rows (past its header), and in *r its row there: the
  // number of blocks that start at i or before it, less one.
  MALVA_HD const uint32_t* row_of(uint32_t i, const uint32_t* start, uint32_t* r) const {
    const int b = lane_block(i, start, D);
    *r = i - start[b];
    return in + b * block_words + head;
  }
  MALVA_HD Raw fetch(int64_t i, const uint32_t* start) const {
    uint32_t r;
    const uint32_t* p = row_of((uint32_t)i, start, &r) + r;
    return {load_ro(p + cap_in * (N + 3)), load_ro(p + cap_in * N), load_ro(p + cap_in * (N + 1)),
            load_ro(p + cap_in * (N + 2)), 0};
  }
  MALVA_HD void fetch2(Raw& r) const { r.word = load_ro(ctx_words + r.lcw); }
  MALVA_HD int dest(const Raw& r, int D) const { return r.own < (uint32_t)D ? (int)r.own : D; }
  MALVA_HD void columns(const Raw& r, int, uint32_t* col) const {
    col[0] = r.cnt;
    col[1] = (r.word >> r.cb) & 1u;
  }
  MALVA_HD const uint32_t* ctx_row(int64_t i, const uint32_t* start) const {
    uint32_t r;
    return row_of((uint32_t)i, start, &r) + (int64_t)r * N;
  }
};

// K8's rows (ref_scan.cu's pack mode): a position whose centre hits the
// alt filter has the code of its context's Bloom index (lo, hi).  It goes
// to the owner of its context word (cw / wps) as its shard-local bit index
// (index - d * wps * 32) in W words, low word first (W = 1 where a shard's
// bits fit in 32); the overflow list keeps the owner beside the W words,
// so that the owner can take it at the end.
template <int W>
struct ScanRows {
  uint32_t wps;

  MALVA_HD int dest(uint32_t lo, uint32_t hi, int D) const {
    const uint32_t d = (uint32_t)(((uint64_t)hi << 32 | lo) >> 5) / wps;
    return d < (uint32_t)D ? (int)d : D;
  }
  MALVA_HD void columns(uint32_t lo, uint32_t hi, int d, uint32_t* col) const {
    const uint64_t local = ((uint64_t)hi << 32 | lo) - (uint64_t)d * wps * 32;
    col[0] = (uint32_t)local;
    if (W == 2) col[1] = (uint32_t)(local >> 32);
    col[W] = (uint32_t)d;
  }
};

// -- K8's tiles (ref_scan.cu's pack mode) -----------------------------------------
// A tile of kTileLanes positions marks its hits in a bitmap (word w holds
// positions 32 w .. 32 w + 31), so that each hit's rank among the tile's
// hits is its place in position order: the hits of the words before its
// own (`pre`, their exclusive prefix) and those below it in its word.
MALVA_HD uint32_t hit_rank(const uint32_t* bm, const uint32_t* pre, int p) {
  return pre[p >> 5] + popc32(bm[p >> 5] & ((1u << (p & 31)) - 1u));
}

// A hit's destination and its rank among the tile's hits of that
// destination, in one word (rank < kTileLanes, destination <= kMaxDests).
constexpr int kRankShift = 5;

MALVA_HD uint32_t dest_rank(int d, uint32_t rank) { return (uint32_t)d | rank << kRankShift; }

// The row of rank `rank` among a tile's rows for a destination (r from
// the look-back: its base, the rows that go to the block and its place in
// the overflow list): its W columns (ScanRows::columns) to row base + rank
// of the block's planes (`rows`, past the header) where rank < r.slot,
// else its W + 1 to row ovf_at + rank - r.slot of the overflow list, where
// that has room.
template <int W>
MALVA_HD void place_row(const DestRun& r, uint32_t rank, const uint32_t* col, uint32_t* rows,
                        int64_t cap, uint32_t* ovf, int64_t ovf_cap) {
  if (rank < r.slot) {
    for (int c = 0; c < W; ++c) rows[c * cap + r.base + rank] = col[c];
    return;
  }
  const int64_t q = r.ovf_at + (rank - r.slot);
  if (q < ovf_cap)
    for (int c = 0; c <= W; ++c) ovf[c * ovf_cap + q] = col[c];
}

}  // namespace malva
