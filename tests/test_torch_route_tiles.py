"""The partitions' tile logic (malva_tpu_torch/csrc/route.cuh) built for
the host with g++, against the kernels' plain versions, bit for bit
(tolerance zero: destinations, ranks, rows and counts are integers): K6's
and K7's, K8's (ref_scan.cu's pack mode) and the live-row map that K7 and
K4's slot entry share.

A host harness emulates one launch of route.cu's kernel with the same
functions: tiles take their tickets in order, each reads the input
blocks' headers, ranks its lanes warp by warp (the ballots and the
shuffle done serially), publishes its status and stages its rows; then,
in an order of tiles given by a seed, each looks back over the statuses
before it (a warp's window, its lanes one after another), takes its place
in the overflow list, writes its runs (the 32 lanes of a warp one after
another) and, when it is the last to finish, resets the scratch.  Any
order gives the same slots, headers and tallies; only the overflow list's
order follows it.  K8's launch is emulated the same way from each
position's code (the scan half's output, which the kernel keeps in its
tile): the tile's hit bitmap and ranks in position order, the ranks by
owner 256 hits at a time, then the same look-back and each row placed.

The plain versions are held against a numpy pack_dests by
tests/test_torch_route.py.
"""

import ctypes
import os
from collections import Counter
import shutil
import subprocess

import numpy as np
import pytest
import torch

from malva_tpu_torch.ops import kernels
from malva_tpu_torch.ops.kernels import HOP1_COLS, HOP2_COLS, SLOT_HEAD, slot_words
from test_torch_route import CASES, hash_words, np_pack_dests, owners

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "malva_tpu_torch", "csrc")

HARNESS_CXX = r"""
#include <stdint.h>
#include <algorithm>
#include <numeric>
#include <random>
#include <vector>
#include "route.cuh"
using namespace malva;

extern "C" int tile_lanes() { return kTileLanes; }
extern "C" int max_tiles() { return kMaxTiles; }
extern "C" int scratch_head() { return kScratchHead; }

// A look-back step of destination e from tile `next` back, the lanes of
// its column of the window one after another; returns the offsets taken.
static int look_back_window(const uint64_t* status, int D, int e, int64_t next, uint32_t* base,
                            bool* done) {
  const int rows = 32 / dest_lanes(D);
  uint64_t w[32][kLookBack];
  int stop = rows * kLookBack;
  for (int j = 0; j < rows; ++j) {
    for (int k = 0; k < kLookBack; ++k) {
      const int64_t at = next - j - rows * k;
      w[j][k] = at >= 0 ? status[at * D + e] : 0;
    }
    stop = std::min(stop, lane_stop(w[j], j, rows));
  }
  bool found = false;
  for (int j = 0; j < rows; ++j) {
    *base += lane_sum(w[j], j, rows, stop);
    found |= lane_prefix_at(w[j], j, rows, stop);
  }
  *done = found;
  return stop + found;
}

// Tile t's base for destination e: its look-back, window by window; false
// where it met an unpublished status before an inclusive prefix.
static bool tile_base(const uint64_t* status, int D, int e, int64_t t, uint32_t* base) {
  bool done = t == 0;
  int64_t next = t - 1;
  while (!done) {
    const int took = look_back_window(status, D, e, next, base, &done);
    if (!took) return false;
    next -= took;
  }
  return true;
}

// One launch over src's tiles; `order` seeds the order in which the tiles
// look back (0: ticket order).  Returns 0, or 1 for too many tiles, 2 for
// a look-back that met an unpublished status.
template <class Src>
static int emulate(const Src& src, int D, uint32_t* const* out, int64_t cap, uint32_t* ovf,
                   int64_t ovf_cap, uint64_t* tally, int tally_at, uint64_t* scratch,
                   unsigned order, int head) {
  constexpr int C = Src::kCols;
  const int N = src.N, bits = dest_bits(D);
  const int64_t n_tiles = src.tiles();
  if (n_tiles > kMaxTiles) return 1;
  uint64_t* status = scratch + kScratchHead;
  uint32_t heads[kMaxDests] = {}, start[kMaxDests + 1] = {};
  for (int d = 0; d < D; ++d) heads[d] = src.head_rows(d);
  block_starts(heads, D, start);
  const int64_t lanes = src.lanes(start), last = last_tile(lanes);
  struct Tile {
    int64_t t;
    bool idle;  // past the last tile that holds a lane
    uint32_t woff[kRouteWarps][kMaxDests];
    DestRun run[kMaxDests];
    std::vector<uint32_t> stage;
  };
  std::vector<Tile> tiles(n_tiles);
  for (Tile& tl : tiles) {  // in ticket order: rank, publish, stage
    const int64_t t = tl.t = (int64_t)scratch[0]++;
    const int live = tile_live(lanes, t);
    tl.idle = t > last;
    if (tl.idle) continue;
    std::vector<int> dest(kTileLanes);
    std::vector<uint32_t> col((size_t)kTileLanes * C), rank(kTileLanes);
    for (int w = 0; w < kRouteWarps; ++w) {
      uint32_t run[32] = {};
      for (int i = 0; i < kRouteItems; ++i) {
        uint32_t valid = 0, ballot[kDestBits] = {};
        for (int lane = 0; lane < 32; ++lane) {
          const int j = item_lane(w, i, lane);
          int d = D;
          if (j < live) {
            typename Src::Raw raw = src.fetch(t * kTileLanes + j, start);
            src.fetch2(raw);
            d = src.dest(raw, D);
            if (d < D) src.columns(raw, d, &col[(size_t)j * C]);
          }
          dest[j] = d;
          valid |= (uint32_t)(d < D) << lane;
          for (int b = 0; b < bits; ++b) ballot[b] |= (uint32_t)(d >> b & 1) << lane;
        }
        for (int lane = 0; lane < 32; ++lane) {
          const int j = item_lane(w, i, lane);
          rank[j] = run[dest[j] & 31] +
                    popc32(dest_mask(valid, ballot, bits, dest[j]) & ((1u << lane) - 1u));
        }
        for (int lane = 0; lane < D; ++lane)
          run[lane] += popc32(dest_mask(valid, ballot, bits, lane));
      }
      for (int e = 0; e < kMaxDests; ++e) tl.woff[w][e] = e < D ? run[e] : 0;
    }
    for (int e = 0; e < D; ++e) {
      tl.run[e].tot = warp_offsets(tl.woff, e);
      status[t * D + e] = status_word(t == 0 ? kStatusPrefix : kStatusAggregate, tl.run[e].tot);
    }
    for (int e = 0; e < D; ++e) {
      tl.run[e].soff = tot_before(tl.run, e);
      for (int w = 0; w < kRouteWarps; ++w) tl.woff[w][e] += tl.run[e].soff;
    }
    tl.stage.assign(stage_words(N, C), 0);
    uint32_t* cols = tl.stage.data() + (size_t)kTileLanes * N;
    for (int j = 0; j < live; ++j) {
      if (dest[j] >= D) continue;
      const uint32_t pos = tl.woff[j / (32 * kRouteItems)][dest[j]] + rank[j];
      for (int c = 0; c < C; ++c) cols[c * kTileLanes + pos] = col[(size_t)j * C + c];
      const uint32_t* row = src.ctx_row(t * kTileLanes + j, start);
      for (int q = 0; q < N; ++q) tl.stage[(size_t)pos * N + q] = row[q];
    }
  }
  std::vector<int64_t> turn(n_tiles);
  std::iota(turn.begin(), turn.end(), 0);
  if (order) std::shuffle(turn.begin(), turn.end(), std::mt19937(order));
  for (int64_t k : turn) {  // look back, place the overflow, write, finish
    Tile& tl = tiles[k];
    const int64_t t = tl.t;
    for (int e = 0; e < D && !tl.idle; ++e) {
      uint32_t base = 0;
      if (!tile_base(status, D, e, t, &base)) return 2;
      if (t > 0) status[t * D + e] = status_word(kStatusPrefix, base + tl.run[e].tot);
      set_base(tl.run[e], base, cap);
    }
    const uint64_t q0 = tally[0];
    tally[0] += tl.idle ? 0 : tot_before(tl.run, D, true);
    for (int e = 0; e < D && !tl.idle; ++e) {
      DestRun& r = tl.run[e];
      r.ovf_at = (int64_t)q0 + tot_before(tl.run, e, true);
      if (t == last) {
        const int64_t total = (int64_t)r.base + r.tot;
        out[e][0] = (uint32_t)(total < cap ? total : cap);
        tally[tally_at + e] += out[e][0];
      }
      const uint32_t* cols = tl.stage.data() + (size_t)kTileLanes * N;
      for (int kind = 0; kind < run_kinds(Src::kSlotCols, Src::kOvfCols); ++kind) {
        const Run w = tile_run<Src::kSlotCols, Src::kOvfCols>(kind, r, out[e] + head,
                                                              tl.stage.data(), cols, N, cap, ovf,
                                                              ovf_cap);
        for (int lane = 0; lane < 32; ++lane) write_run(w.dst, w.src, w.n, lane, 32);
      }
    }
    if (++scratch[1] == (uint64_t)n_tiles) {
      for (int64_t q = 0; q < (last + 1) * D; ++q) status[q] = 0;
      scratch[0] = scratch[1] = 0;
    }
  }
  return 0;
}

extern "C" int emulate_pack(const uint32_t* hx, const uint32_t* ctx, const uint32_t* cnt,
                            int64_t B, int wc, uint64_t size_bits, uint32_t wps, int D,
                            uint32_t* const* out, int64_t cap, uint32_t* ovf, int64_t ovf_cap,
                            uint64_t* tally, uint64_t* scratch, unsigned order, int head) {
  const PackLanes src{hx, ctx, cnt, B, wps, size_bits, wc};
  return emulate(src, D, out, cap, ovf, ovf_cap, tally, 1, scratch, order, head);
}

extern "C" int emulate_probe(const uint32_t* in, int64_t cap_in, int wc,
                             const uint32_t* ctx_words, int D, uint32_t* const* out,
                             int64_t cap, uint32_t* ovf, int64_t ovf_cap, uint64_t* tally,
                             uint64_t* scratch, unsigned order, int head, int hop1_cols) {
  const ProbeLanes src{in, ctx_words, cap_in, head + cap_in * (wc + hop1_cols), head, wc, D};
  return emulate(src, D, out, cap, ovf, ovf_cap, tally, 1 + D, scratch, order, head);
}

// One launch of K8's partition (ref_scan.cu's pack mode) over n
// positions' codes (int64 as u32 pairs: the context's Bloom index, or -1
// for no hit): each tile, in ticket order, marks its hits in a bitmap as
// its warps' ballots do (word g * 8 + w: positions g * 256 + w * 32 + lane),
// ranks them in position order (hit_rank) from the warps' queues, puts
// each hit's columns and owner at its rank, ranks them by owner 256 at a
// time (each warp's ballots done serially, the warps' counts summed in
// warp order) and publishes its counts; then, in the seeded order, each
// looks back, takes its place in the overflow list and places its rows.
// Each of the launch's blocks takes one tile here, and one ticket more.
template <int W>
static int emulate_pack(const uint32_t* codes, int64_t n, uint32_t wps, int D,
                        uint32_t* const* out, int64_t cap, uint32_t* ovf, int64_t ovf_cap,
                        uint64_t* tally, uint64_t* scratch, unsigned order, int head) {
  constexpr int kWarps = kRouteWarps, kWords = kTileLanes / 32;
  const int64_t n_tiles = last_tile(n) + 1, last = n_tiles - 1;
  if (n_tiles > kMaxTiles) return 1;
  const int bits = dest_bits(D);
  const ScanRows<W> rows{wps};
  uint64_t* status = scratch + kScratchHead;
  struct Tile {
    int64_t t;
    uint32_t n;
    DestRun run[kMaxDests];
    std::vector<uint32_t> col, rk;
  };
  std::vector<Tile> tiles(n_tiles);
  for (Tile& tl : tiles) {
    const int64_t t = tl.t = (int64_t)scratch[0]++;
    const int n_here = tile_live(n, t);
    auto code = [&](int p, uint32_t* lo, uint32_t* hi) {
      *lo = codes[2 * (t * kTileLanes + p)];
      *hi = codes[2 * (t * kTileLanes + p) + 1];
      return (*lo & *hi) != ~0u;
    };
    uint32_t bm[kWords] = {}, pre[kWords + 1] = {}, lo, hi;
    for (int g = 0; g < kWords / kWarps; ++g)
      for (int w = 0; w < kWarps; ++w)
        for (int lane = 0; lane < 32; ++lane) {
          const int p = g * kTileLanes / (kWords / kWarps) + w * 32 + lane;
          if (p < n_here && code(p, &lo, &hi)) bm[g * kWarps + w] |= 1u << lane;
        }
    for (int q = 0; q < kWords; ++q) pre[q + 1] = pre[q] + popc32(bm[q]);
    tl.n = pre[kWords];
    tl.col.assign((size_t)W * kTileLanes, 0);
    tl.rk.assign(kTileLanes, 0);
    for (int w = 0; w < kWarps; ++w)  // each warp's queue: its positions, group after group
      for (int g = 0; g < kWords / kWarps; ++g)
        for (int lane = 0; lane < 32; ++lane) {
          const int p = g * kTileLanes / (kWords / kWarps) + w * 32 + lane;
          if (p >= n_here || !code(p, &lo, &hi)) continue;
          const uint32_t at = hit_rank(bm, pre, p);
          const int d = rows.dest(lo, hi, D);
          uint32_t col[W + 1];
          rows.columns(lo, hi, d, col);
          for (int c = 0; c < W; ++c) tl.col[(size_t)c * kTileLanes + at] = col[c];
          tl.rk[at] = (uint32_t)d;
        }
    for (int e = 0; e < kMaxDests; ++e) tl.run[e] = DestRun{};
    for (uint32_t c0 = 0; c0 < tl.n; c0 += kRouteThreads) {
      uint32_t woff[kWarps][kMaxDests] = {}, below[kRouteThreads] = {};
      int dest[kRouteThreads];
      for (int w = 0; w < kWarps; ++w) {
        uint32_t valid = 0, ballot[kDestBits] = {};
        for (int lane = 0; lane < 32; ++lane) {
          const uint32_t j = c0 + w * 32 + lane;
          const int d = dest[w * 32 + lane] = j < tl.n ? (int)tl.rk[j] : D;
          valid |= (uint32_t)(d < D) << lane;
          for (int b = 0; b < bits; ++b) ballot[b] |= (uint32_t)(d >> b & 1) << lane;
        }
        for (int lane = 0; lane < 32; ++lane)
          below[w * 32 + lane] =
              popc32(dest_mask(valid, ballot, bits, dest[w * 32 + lane]) & ((1u << lane) - 1u));
        for (int e = 0; e < D; ++e) woff[w][e] = popc32(dest_mask(valid, ballot, bits, e));
      }
      for (int e = 0; e < D; ++e) {
        uint32_t run = tl.run[e].tot;
        for (int w = 0; w < kWarps; ++w) {
          const uint32_t c = woff[w][e];
          woff[w][e] = run;
          run += c;
        }
        tl.run[e].tot = run;
      }
      for (int i = 0; i < kRouteThreads && c0 + i < tl.n; ++i)
        if (dest[i] < D) tl.rk[c0 + i] = dest_rank(dest[i], woff[i / 32][dest[i]] + below[i]);
    }
    for (int e = 0; e < D; ++e)
      status[t * D + e] = status_word(t == 0 ? kStatusPrefix : kStatusAggregate, tl.run[e].tot);
  }
  scratch[0] += n_tiles;  // each block's ticket past the last tile
  std::vector<int64_t> turn(n_tiles);
  std::iota(turn.begin(), turn.end(), 0);
  if (order) std::shuffle(turn.begin(), turn.end(), std::mt19937(order));
  for (int64_t k : turn) {
    Tile& tl = tiles[k];
    const int64_t t = tl.t;
    for (int e = 0; e < D; ++e) {
      uint32_t base = 0;
      if (!tile_base(status, D, e, t, &base)) return 2;
      if (t > 0) status[t * D + e] = status_word(kStatusPrefix, base + tl.run[e].tot);
      set_base(tl.run[e], base, cap);
    }
    const uint64_t q0 = tally[0];
    tally[0] += tot_before(tl.run, D, true);
    for (int e = 0; e < D; ++e) {
      DestRun& r = tl.run[e];
      r.ovf_at = (int64_t)q0 + tot_before(tl.run, e, true);
      if (t == last) {
        const int64_t total = (int64_t)r.base + r.tot;
        out[e][0] = (uint32_t)(total < cap ? total : cap);
        tally[1 + e] += out[e][0];
      }
    }
    for (uint32_t j = 0; j < tl.n; ++j) {
      const uint32_t v = tl.rk[j];
      const int d = (int)(v & ((1u << kRankShift) - 1u));
      if (d >= D) continue;
      uint32_t col[W + 1];
      for (int c = 0; c < W; ++c) col[c] = tl.col[(size_t)c * kTileLanes + j];
      col[W] = (uint32_t)d;
      place_row<W>(tl.run[d], v >> kRankShift, col, out[d] + head, cap, ovf, ovf_cap);
    }
    if (++scratch[1] == (uint64_t)n_tiles) {
      for (int64_t q = 0; q < n_tiles * D; ++q) status[q] = 0;
      scratch[0] = scratch[1] = 0;
    }
  }
  return 0;
}

extern "C" int emulate_scan(const uint32_t* codes, int64_t n, uint32_t wps, int W, int D,
                            uint32_t* const* out, int64_t cap, uint32_t* ovf, int64_t ovf_cap,
                            uint64_t* tally, uint64_t* scratch, unsigned order, int head) {
  if (W == 1)
    return emulate_pack<1>(codes, n, wps, D, out, cap, ovf, ovf_cap, tally, scratch, order, head);
  return emulate_pack<2>(codes, n, wps, D, out, cap, ovf, ovf_cap, tally, scratch, order, head);
}

// The live-row maps of D blocks of cap rows whose headers are `heads`.
// K4's slot entry: each block's live rows cut into whole tiles of `tile`
// lanes (its kernel's prologue and SlotPolicy::stage), the rows of each
// tile, in tile order, into slot_b and slot_r; K7: each of the launch's
// lanes, the live rows packed block after block, by ProbeLanes::row_of
// into k7_b and k7_r.  Returns the live rows, or -1 where the slot entry
// stages a row twice or a tile holds rows of two blocks.
extern "C" int64_t live_maps(const uint32_t* heads_in, int D, int64_t cap, int tile,
                             uint32_t* slot_b, uint32_t* slot_r, uint32_t* k7_b, uint32_t* k7_r) {
  uint32_t rows_in[kMaxDests], tiles[kMaxDests], first_tile[kMaxDests + 1];
  for (int d = 0; d < D; ++d) {
    rows_in[d] = live_rows(heads_in[d], cap);
    tiles[d] = (rows_in[d] + tile - 1) / tile;
  }
  block_starts(tiles, D, first_tile);
  uint32_t at = 0;
  for (uint32_t t = 0; t < first_tile[D]; ++t) {
    const int b = lane_block(t, first_tile, D);
    const uint32_t row = (t - first_tile[b]) * tile, left = rows_in[b] - row;
    const uint32_t n = left < (uint32_t)tile ? left : (uint32_t)tile;
    for (uint32_t i = 0; i < n; ++i, ++at) {
      if (at > 0 && slot_b[at - 1] == (uint32_t)b && slot_r[at - 1] >= row + i) return -1;
      slot_b[at] = (uint32_t)b;
      slot_r[at] = row + i;
    }
  }
  const int block_words = 1;  // K7's blocks: their headers alone
  uint32_t start[kMaxDests + 1];
  block_starts(rows_in, D, start);
  std::vector<uint32_t> in(D * block_words);
  for (int d = 0; d < D; ++d) in[d] = heads_in[d];
  const ProbeLanes probe{in.data(), nullptr, cap, block_words, 0, 0, D};
  for (uint32_t i = 0; i < start[D]; ++i) {
    uint32_t r = 0;
    k7_b[i] = (uint32_t)(probe.row_of(i, start, &r) - in.data()) / block_words;
    k7_r[i] = r;
  }
  for (int d = 0; d < D; ++d)
    if (probe.head_rows(d) != rows_in[d]) return -1;
  return at == start[D] ? (int64_t)at : -1;
}

// One look-back step over `statuses` (n of them, nearest first: tile
// n - 1 down to tile 0) as destination 0 of D.
extern "C" int look_back(const uint64_t* statuses, int64_t n, int D, uint32_t* sum, int* done) {
  std::vector<uint64_t> status((size_t)n * D);
  for (int64_t q = 0; q < n; ++q) status[(size_t)(n - 1 - q) * D] = statuses[q];
  bool d = false;
  const int took = look_back_window(status.data(), D, 0, n - 1, sum, &d);
  *done = d;
  return took;
}

extern "C" void write_words(uint32_t* dst, const uint32_t* src, int64_t n, int width) {
  for (int lane = 0; lane < width; ++lane) write_run(dst, src, n, lane, width);
}
"""


@pytest.fixture(scope="module")
def tiles_cxx(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("route_tiles")
    (d / "tiles.cpp").write_text(HARNESS_CXX)
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Werror",
                    "-Wno-unknown-pragmas", f"-I{CSRC}", "-o", str(d / "tiles.so"),
                    str(d / "tiles.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "tiles.so"))
    p, i, i64, u32, u64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32,
                           ctypes.c_uint64)
    lib.emulate_pack.argtypes = [p, p, p, i64, i, u64, u32, i, p, i64, p, i64, p, p,
                                 ctypes.c_uint, i]
    lib.emulate_probe.argtypes = [p, i64, i, p, i, p, i64, p, i64, p, p, ctypes.c_uint, i, i]
    lib.emulate_scan.argtypes = [p, i64, u32, i, i, p, i64, p, i64, p, p, ctypes.c_uint, i]
    lib.live_maps.argtypes = [p, i, i64, i, p, p, p, p]
    lib.live_maps.restype = i64
    lib.look_back.argtypes = [p, i64, i, p, p]
    lib.write_words.argtypes = [p, p, i64, i]
    return lib


WC = 3
T = 2048  # route.cuh kTileLanes, checked by test_tile_constants


def test_tile_constants(tiles_cxx):
    """The tile size these tests cut their cases by, the lanes a launch
    takes (ops/kernels.py ROUTE_MAX_LANES), and the scratch the wrapper
    makes: a ticket, a count of finished tiles and a status per tile and
    destination (ops/kernels.py route_scratch asks the kernel library,
    whose malva_route_scratch_words is kScratchHead + kMaxTiles * D)."""
    assert tiles_cxx.tile_lanes() == T
    assert tiles_cxx.scratch_head() == 2 and tiles_cxx.max_tiles() == 1 << 16
    assert T * tiles_cxx.max_tiles() == kernels.ROUTE_MAX_LANES
    route_cu = open(os.path.join(CSRC, "route.cu")).read()
    assert "return kScratchHead + (int64_t)kMaxTiles * D;" in route_cu


def _pointers(arrays):
    return (ctypes.c_void_p * len(arrays))(*[a.ctypes.data for a in arrays])


def _scratch(lib, D):
    return np.zeros(lib.scratch_head() + lib.max_tiles() * D, np.uint64)


def _u32(a):
    return np.ascontiguousarray(np.asarray(a, np.int64).astype(np.uint32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _ovf_rows(ovf, n, ovf_cap):
    """The rows an overflow list holds (the first min(n, ovf_cap)), sorted."""
    o = np.asarray(ovf).view(np.int32)
    k = min(n, ovf_cap)
    r = np.concatenate([o[: ovf_cap * WC].reshape(ovf_cap, WC)[:k], o[ovf_cap * WC :][:k, None]],
                       axis=1)
    return r[np.lexsort(r.T[::-1])]


def _same_route(blocks, ovf, tally, want_blocks, want_ovf, want_tally, ovf_cap, spilled=None):
    """Blocks and tallies bit for bit; overflow lists as sorted rows (the
    emulated atomics land in the seeded order).  Where more rows spilled
    than the list holds, the list holds ovf_cap of ``spilled`` (all the
    rows that spilled, from a list with room)."""
    for got, want in zip(blocks, want_blocks):
        np.testing.assert_array_equal(got.view(np.int32), want.numpy())
    np.testing.assert_array_equal(tally.view(np.int64), want_tally.numpy())
    n = int(want_tally[0])
    got = _ovf_rows(ovf, n, ovf_cap)
    if n <= ovf_cap:
        np.testing.assert_array_equal(got, _ovf_rows(want_ovf.numpy(), n, ovf_cap))
    else:
        rows = {tuple(r) for r in spilled}
        assert len(spilled) == n and all(tuple(r) in rows for r in got)
        assert len({tuple(r) for r in got}) == len(np.unique(got, axis=0))


def _pack_inputs(rng, n, D, case):
    """A source slice of n lanes (JAX's capacity for it) whose context
    words go to owners as ``case`` says; a tenth of the counters zero.
    D = 3 at 3 * 2^33 bits (the index's n_gib rule), else 2^20 bits."""
    size_bits = 3 << 33 if D == 3 else 1 << 20
    wps = size_bits // 32 // D
    dest = owners(rng, n, D, case)
    cw = dest * wps + rng.integers(0, wps, n)
    bw = owners(rng, n, D, "spread") * wps + rng.integers(0, wps, n)
    x_hi, x_lo = hash_words(rng, cw, size_bits)
    c_hi, c_lo = hash_words(rng, bw, size_bits)
    counters = np.where(rng.random(n) < 0.1, 0, rng.integers(1, 1 << 32, n))
    hx = _u32(np.stack([x_hi, x_lo, c_hi, c_lo]).reshape(4, n))
    ctx = _u32(rng.integers(0, 1 << 32, (n, WC)))
    return hx, ctx, _u32(counters), size_bits, wps, dest, cw, bw


def _run_pack(lib, hx, ctx, counters, size_bits, wps, D, cap, ovf_cap, order, scratch,
              blocks=None, ovf=None, tally=None):
    n = counters.shape[0]
    w = slot_words(cap, WC, HOP1_COLS)
    blocks = [np.zeros(w, np.uint32) for _ in range(D)] if blocks is None else blocks
    ovf = np.zeros(ovf_cap * (WC + 1), np.uint32) if ovf is None else ovf
    tally = np.zeros(1 + 2 * D, np.uint64) if tally is None else tally
    err = lib.emulate_pack(hx.ctypes.data, ctx.ctypes.data, counters.ctypes.data, n, WC,
                           size_bits, wps, D, _pointers(blocks), cap, ovf.ctypes.data, ovf_cap,
                           tally.ctypes.data, scratch.ctypes.data, order, SLOT_HEAD)
    assert err == 0
    return blocks, ovf, tally


def _plain_pack(hx, ctx, counters, size_bits, wps, D, cap, ovf_cap, blocks=None, ovf=None,
                tally=None):
    w = slot_words(cap, WC, HOP1_COLS)
    blocks = [torch.zeros(w, dtype=torch.int32) for _ in range(D)] if blocks is None else blocks
    ovf = torch.zeros(ovf_cap * (WC + 1), dtype=torch.int32) if ovf is None else ovf
    tally = torch.zeros(1 + 2 * D, dtype=torch.int64) if tally is None else tally
    kernels.route_pack_plain(_t(hx), _t(ctx), _t(counters), blocks, ovf, tally,
                             size_bits=size_bits, wps=wps, cap=cap)
    return blocks, ovf, tally


def _check_pack(lib, rng, n, D, case, order, cap=None):
    hx, ctx, counters, size_bits, wps, dest, cw, bw = _pack_inputs(rng, n, D, case)
    cap = kernels_capacity(n, D) if cap is None else cap
    ovf_cap = n + 1
    scratch = _scratch(lib, D)
    got = _run_pack(lib, hx, ctx, counters, size_bits, wps, D, cap, ovf_cap, order, scratch)
    want = _plain_pack(hx, ctx, counters, size_bits, wps, D, cap, ovf_cap)
    _same_route(*got, *want, ovf_cap)
    assert not scratch.any()  # the last tile to finish reset it
    # and through the plain version, numpy's pack_dests
    payload = np.concatenate([ctx.astype(np.int64),
                              np.stack([counters, cw - dest * wps, hx[1] & 31, bw // wps], 1)],
                             axis=1)
    slots, counts, over = np_pack_dests(dest, payload, counters > 0, D, cap)
    for d in range(D):
        b = got[0][d].astype(np.int64)
        assert b[0] == counts[d]
        rows = np.concatenate([b[SLOT_HEAD : SLOT_HEAD + cap * WC].reshape(cap, WC),
                               b[SLOT_HEAD + cap * WC :].reshape(HOP1_COLS, cap).T], axis=1)
        np.testing.assert_array_equal(rows, slots[d * cap : (d + 1) * cap])
    assert int(got[2][0]) == over.shape[0]
    return over.shape[0]


def kernels_capacity(n, D):
    from malva_tpu_torch.parallel.sharded_index import capacity

    return capacity(n, D)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("D", [1, 2, 3, 8, 16])
def test_pack_tiles_match_plain(tiles_cxx, D, case):
    """K6's emulated launch over 5 tiles and a lane (JAX's capacity; the
    clumped and one-owner cases overflow it) equals route_pack_plain and
    numpy's pack_dests, with the tiles looking back in a shuffled order."""
    rng = np.random.default_rng(1000 + 10 * D + CASES.index(case))
    n = 0 if case == "empty" else 5 * T + 1
    spilled = _check_pack(tiles_cxx, rng, n, D, case, order=7 + D)
    if case == "one" and D > 2:
        assert spilled > 0


@pytest.mark.parametrize("n", [0, 1, T - 1, T, 9 * T + 1])
@pytest.mark.parametrize("D", [1, 4, 16])
def test_pack_tile_edges(tiles_cxx, n, D):
    """K6 from no lane to many tiles and a lane, at D = 1, 4 and 16, with
    a capacity of a third of the lanes and a small overflow list: rows
    past cap spill, and past the list's room are counted but dropped."""
    rng = np.random.default_rng(2000 + n + D)
    hx, ctx, counters, size_bits, wps, *_ = _pack_inputs(rng, n, D, "clumped")
    cap, ovf_cap = max(1, n // 3), max(1, n // 8)
    want = _plain_pack(hx, ctx, counters, size_bits, wps, D, cap, ovf_cap)
    roomy = _plain_pack(hx, ctx, counters, size_bits, wps, D, cap, n + 1)
    spilled = _ovf_rows(roomy[1].numpy(), int(roomy[2][0]), n + 1)
    if n > T:
        assert int(want[2][0]) > ovf_cap  # the list overflows
    for order in (0, 99):
        scratch = _scratch(tiles_cxx, D)
        got = _run_pack(tiles_cxx, hx, ctx, counters, size_bits, wps, D, cap, ovf_cap, order,
                        scratch)
        _same_route(*got, *want, ovf_cap, spilled)
        assert not scratch.any()


@pytest.mark.parametrize("D", [2, 16])
def test_two_launches_on_one_scratch(tiles_cxx, D):
    """Two launches of K6 (the second over a longer slice, into the same
    blocks, list and tally) and then one of K7, all on one scratch: each
    leaves it zeroed, and the blocks, list and tally equal the plain
    versions' after the same calls."""
    rng = np.random.default_rng(3000 + D)
    scratch = _scratch(tiles_cxx, D)
    cap, ovf_cap = 3 * T // D, 16 * T
    blocks = ovf = tally = None
    want = (None, None, None)
    for n in (3 * T + 5, 4 * T + 17):
        hx, ctx, counters, size_bits, wps, *_ = _pack_inputs(rng, n, D, "clumped")
        blocks, ovf, tally = _run_pack(tiles_cxx, hx, ctx, counters, size_bits, wps, D, cap,
                                       ovf_cap, 5, scratch, blocks, ovf, tally)
        want = _plain_pack(hx, ctx, counters, size_bits, wps, D, cap, ovf_cap, *want)
        assert not scratch.any()
        _same_route(blocks, ovf, tally, *want, ovf_cap)
    assert tally[0] > 0
    received, ctx_words, cap_in = _probe_inputs(rng, D, "spread", 2 * T + 3)
    got = _run_probe(tiles_cxx, received, ctx_words, D, cap_in, cap, ovf_cap, 11, scratch)
    plain = _plain_probe(received, ctx_words, D, cap_in, cap, ovf_cap)
    _same_route(*got, *plain, ovf_cap)
    assert not scratch.any()


def _probe_inputs(rng, D, case, cap_in):
    """D received hop-1 blocks of cap_in rows: each full, empty or part
    full at random (one full at least unless empty), stale rows past the
    counts, owners as ``case`` says."""
    n_ctx_words = 5000
    ctx_words = rng.integers(0, 1 << 32, n_ctx_words)
    fill = [0 if case == "empty" else
            int(rng.choice([0, cap_in, rng.integers(1, max(2, cap_in))])) for _ in range(D)]
    if case != "empty" and max(fill) == 0:
        fill[0] = cap_in
    w1 = slot_words(cap_in, WC, HOP1_COLS)
    received = np.zeros(D * w1, np.int64)
    for b in range(D):
        rows = np.concatenate([rng.integers(0, 1 << 32, (cap_in, WC + 1)),
                               rng.integers(0, n_ctx_words, (cap_in, 1)),
                               rng.integers(0, 32, (cap_in, 1)),
                               owners(rng, cap_in, D, "spread" if case == "empty" else case)
                               [:, None]], axis=1)
        blk = received[b * w1 : (b + 1) * w1]
        blk[0] = fill[b]
        blk[SLOT_HEAD : SLOT_HEAD + cap_in * WC] = rows[:, :WC].reshape(-1)
        blk[SLOT_HEAD + cap_in * WC :] = rows[:, WC:].T.reshape(-1)
    return _u32(received), _u32(ctx_words), cap_in


def _run_probe(lib, received, ctx_words, D, cap_in, cap, ovf_cap, order, scratch):
    blocks = [np.zeros(slot_words(cap, WC, HOP2_COLS), np.uint32) for _ in range(D)]
    ovf = np.zeros(ovf_cap * (WC + 1), np.uint32)
    tally = np.zeros(1 + 2 * D, np.uint64)
    err = lib.emulate_probe(received.ctypes.data, cap_in, WC, ctx_words.ctypes.data, D,
                            _pointers(blocks), cap, ovf.ctypes.data, ovf_cap, tally.ctypes.data,
                            scratch.ctypes.data, order, SLOT_HEAD, HOP1_COLS)
    assert err == 0
    return blocks, ovf, tally


def _plain_probe(received, ctx_words, D, cap_in, cap, ovf_cap):
    blocks = [torch.zeros(slot_words(cap, WC, HOP2_COLS), dtype=torch.int32) for _ in range(D)]
    ovf = torch.zeros(ovf_cap * (WC + 1), dtype=torch.int32)
    tally = torch.zeros(1 + 2 * D, dtype=torch.int64)
    kernels.route_probe_plain(_t(received), _t(ctx_words), blocks, ovf, tally, wc=WC,
                              cap_in=cap_in, cap=cap)
    return blocks, ovf, tally


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("D", [1, 2, 3, 8, 16])
def test_probe_tiles_match_plain(tiles_cxx, D, case):
    """K7's emulated launch over D received blocks of 2 tiles and a row
    each, part full at random (a launch's lanes are the live rows, block
    after block, so a tile can span the end of one block and the start of
    the next, and the tiles past them do nothing) equals route_probe_plain,
    and through it numpy's pack_dests of the live rows by Bloom-word owner,
    with the context-filter bit."""
    rng = np.random.default_rng(4000 + 10 * D + CASES.index(case))
    cap_in = 2 * T + 1
    received, ctx_words, _ = _probe_inputs(rng, D, case, cap_in)
    cap = kernels_capacity(cap_in, D)
    ovf_cap = D * cap_in
    scratch = _scratch(tiles_cxx, D)
    got = _run_probe(tiles_cxx, received, ctx_words, D, cap_in, cap, ovf_cap, 3 + D, scratch)
    want = _plain_probe(received, ctx_words, D, cap_in, cap, ovf_cap)
    _same_route(*got, *want, ovf_cap)
    assert not scratch.any()
    w1 = slot_words(cap_in, WC, HOP1_COLS)
    live = []
    for b in range(D):
        blk = received[b * w1 : (b + 1) * w1].astype(np.int64)
        rows = np.concatenate([blk[SLOT_HEAD : SLOT_HEAD + cap_in * WC].reshape(cap_in, WC),
                               blk[SLOT_HEAD + cap_in * WC :].reshape(HOP1_COLS, cap_in).T], 1)
        live.append(rows[: blk[0]])
    live = np.concatenate(live)
    known = (ctx_words.astype(np.int64)[live[:, WC + 1]] >> live[:, WC + 2]) & 1
    payload = np.concatenate([live[:, : WC + 1], known[:, None]], axis=1)
    slots, counts, over = np_pack_dests(live[:, WC + 3], payload, np.ones(len(live), bool), D,
                                        cap)
    for d in range(D):
        b = got[0][d].astype(np.int64)
        assert b[0] == counts[d]
        rows = np.concatenate([b[SLOT_HEAD : SLOT_HEAD + cap * WC].reshape(cap, WC),
                               b[SLOT_HEAD + cap * WC :].reshape(HOP2_COLS, cap).T], axis=1)
        np.testing.assert_array_equal(rows, slots[d * cap : (d + 1) * cap])
    assert int(got[2][0]) == over.shape[0]


@pytest.mark.parametrize("cap_in", [1, T - 1, T, 3 * T + 1])
def test_probe_block_edges(tiles_cxx, cap_in):
    """K7 over 4 blocks of 1 row up to 3 tiles and a row, with a small
    slot capacity and overflow list."""
    rng = np.random.default_rng(5000 + cap_in)
    D = 4
    received, ctx_words, _ = _probe_inputs(rng, D, "clumped", cap_in)
    cap, ovf_cap = max(1, cap_in // 2), D * cap_in
    for order in (0, 13):
        scratch = _scratch(tiles_cxx, D)
        got = _run_probe(tiles_cxx, received, ctx_words, D, cap_in, cap, ovf_cap, order, scratch)
        want = _plain_probe(received, ctx_words, D, cap_in, cap, ovf_cap)
        _same_route(*got, *want, ovf_cap)
        assert not scratch.any()


AGG, PRE = 1 << 62, 2 << 62


def _look_back_reference(statuses, width):
    """A look-back step read one status after another, nearest first, over
    the first ``width``: (taken, sum mod 2^32, done)."""
    total = 0
    for q, st in enumerate(statuses[:width]):
        flag = st >> 62
        if flag == 0:
            return q, total, False
        total = (total + (st & 0xFFFFFFFF)) & 0xFFFFFFFF
        if flag == 2:
            return q + 1, total, True
    return min(width, len(statuses)), total, False


@pytest.mark.parametrize("D", [1, 3, 4, 16])
@pytest.mark.parametrize("kind", ["prefix", "unpublished", "aggregates", "wrap", "edges"])
def test_look_back_window(tiles_cxx, D, kind):
    """A warp's look-back step (a window of 16 x 32 / D' tiles, D' = D
    rounded up to a power of two, each lane its share, the stop and the
    sums reduced over the lanes) equals reading the statuses one after
    another: aggregates summed up to the first inclusive prefix (then
    done), a stop before an unpublished status, a whole window of
    aggregates taken; counts wrap at 2^32 as the device's do."""
    width = 16 * (32 // (1 << (D - 1).bit_length()))
    rng = np.random.default_rng(D * 7 + len(kind))
    for _ in range(40):
        n = int(rng.integers(1, 3 * width))
        counts = rng.integers(0, 1 << 32 if kind == "wrap" else 1000, n).astype(np.uint64)
        flags = np.full(n, 1, np.uint64)
        if kind in ("prefix", "wrap"):
            flags[rng.integers(0, n)] = 2
        elif kind == "unpublished":
            flags[rng.integers(0, n)] = 0
            flags[rng.integers(0, n)] = 2
        elif kind == "edges":
            flags[min(n - 1, width - 1 + int(rng.integers(0, 2)))] = 2
        flags[-1] = 2  # tile 0 always holds its prefix
        statuses = (flags << np.uint64(62)) | counts
        total, done = ctypes.c_uint32(0), ctypes.c_int(0)
        took = tiles_cxx.look_back(statuses.ctypes.data, n, D, ctypes.byref(total),
                                   ctypes.byref(done))
        assert (took, total.value, bool(done.value)) == _look_back_reference(
            [int(x) for x in statuses], width)


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 37, 128, 1001])
@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_write_run(tiles_cxx, n, shift):
    """A run of n words written by a warp to a destination at each
    alignment mod 16 bytes (16-byte stores in the middle) lands whole and
    touches nothing around it."""
    rng = np.random.default_rng(n * 4 + shift)
    src = _u32(rng.integers(0, 1 << 32, n + 1))
    dst = np.zeros(n + 12, np.uint32)
    at = (-(dst.ctypes.data // 4) + shift) % 4  # dst + at: `shift` words past a 16-byte boundary
    tiles_cxx.write_words(dst.ctypes.data + 4 * at, src.ctypes.data, n, 32)
    np.testing.assert_array_equal(dst[at : at + n], src[:n])
    assert not dst[:at].any() and not dst[at + n :].any()


def _scan_codes(rng, n, D, W, miss=0.2):
    """n positions' codes from K8's scan half (int64 Bloom indices; a
    share ``miss`` of them miss, -1, but none of the second tile, where
    there is one, so that a tile holds kTileLanes hits) whose context words
    go mostly to owner 0 (clumped), on shards of wps words: 2^15 (rows of
    one word) or 2^28 (a shard's bits past 2^32: two)."""
    wps = 1 << 15 if W == 1 else 1 << 28
    word = owners(rng, n, D, "clumped") * wps + rng.integers(0, wps, n)
    lost = rng.random(n) < miss
    lost[T : 2 * T] = False
    codes = np.where(lost, -1, word * 32 + rng.integers(0, 32, n))
    return codes.astype(np.int64), wps


def _scan_ovf_rows(ovf, n, W, ovf_cap):
    """The rows a scan overflow list holds ([W planes | owner plane] of
    ovf_cap), the first min(n, ovf_cap), sorted."""
    o = np.asarray(ovf).view(np.int32).reshape(W + 1, ovf_cap)[:, : min(n, ovf_cap)].T
    return o[np.lexsort(o.T[::-1])]


def _check_scan(lib, D, n, W, codes, wps, cap, ovf_cap):
    """K8's emulated launch over n positions' codes (two orders of the
    look-backs) against scan_partition_plain: blocks, headers and tallies
    bit for bit, the overflow list's rows (with their owners) as a multiset,
    the scratch left zeroed, every slot row its hit's shard-local bit index
    in position order.  Returns the rows spilled."""
    w = kernels.scan_slot_words(cap, W)
    want = ([torch.zeros(w, dtype=torch.int32) for _ in range(D)],
            torch.zeros(ovf_cap * (W + 1), dtype=torch.int32),
            torch.zeros(1 + D, dtype=torch.int64))
    kernels.scan_partition_plain(torch.from_numpy(codes), *want, wps=wps, cap=cap)
    roomy = torch.zeros((n + 1) * (W + 1), dtype=torch.int32)
    kernels.scan_partition_plain(torch.from_numpy(codes), [torch.zeros_like(b) for b in want[0]],
                                 roomy, torch.zeros(1 + D, dtype=torch.int64), wps=wps, cap=cap)
    spilled = int(want[2][0])
    every = Counter(map(tuple, _scan_ovf_rows(roomy.numpy(), spilled, W, n + 1)))
    for order in (0, 17 + D):
        scratch = _scratch(lib, D)
        blocks = [np.zeros(w, np.uint32) for _ in range(D)]
        ovf = np.zeros(ovf_cap * (W + 1), np.uint32)
        tally = np.zeros(1 + D, np.uint64)
        err = lib.emulate_scan(codes.ctypes.data, n, wps, W, D, _pointers(blocks), cap,
                               ovf.ctypes.data, ovf_cap, tally.ctypes.data, scratch.ctypes.data,
                               order, SLOT_HEAD)
        assert err == 0
        for got, b in zip(blocks, want[0]):
            np.testing.assert_array_equal(got.view(np.int32), b.numpy())
        np.testing.assert_array_equal(tally.view(np.int64), want[2].numpy())
        got_rows = _scan_ovf_rows(ovf, spilled, W, ovf_cap)
        if spilled <= ovf_cap:
            np.testing.assert_array_equal(got_rows, _scan_ovf_rows(want[1].numpy(), spilled, W,
                                                                   ovf_cap))
        else:  # ovf_cap of the rows that spilled (two hits may share a code)
            assert len(got_rows) == ovf_cap and not Counter(map(tuple, got_rows)) - every
        assert not scratch.any()
    hits = codes[codes >= 0]
    for d in range(D):
        live = int(want[0][d][0])
        rows = want[0][d][SLOT_HEAD:].numpy().view(np.uint32).astype(np.int64).reshape(W, cap)
        local = rows[0] | (rows[1] << 32 if W == 2 else 0)
        mine = hits[hits // (32 * wps) == d]
        np.testing.assert_array_equal(local[:live], (mine - d * 32 * wps)[:cap])
    return spilled


@pytest.mark.parametrize("W", [1, 2])
@pytest.mark.parametrize("n", [0, 1, T - 1, T, 5 * T + 1])
@pytest.mark.parametrize("D", [1, 2, 3, 8, 16])
def test_scan_tiles_match_plain(tiles_cxx, D, n, W):
    """K8's fused partition (ScanRows, rows of W words) emulated from no
    position to five tiles and a position (its second tile all hits), per
    tile: the hit bitmap and ranks in position order, the ranks by owner,
    the look-back; with a slot capacity of a sixth of the positions and a
    list of a sixteenth, so that rows spill to the overflow list and, past
    many tiles, out of it.  Equal to scan_partition_plain (_check_scan)."""
    rng = np.random.default_rng(6000 + 100 * D + 10 * W + n % 97)
    codes, wps = _scan_codes(rng, n, D, W)
    spilled = _check_scan(tiles_cxx, D, n, W, codes, wps, max(1, n // 6), max(1, n // 16))
    if n > T:
        assert spilled > max(1, n // 16)  # the list overflows


@pytest.mark.parametrize("D", [1, 4, 16])
def test_scan_all_hit_tiles(tiles_cxx, D):
    """Every position hits: three tiles of kTileLanes hits and a partial
    one, each ranked 256 hits at a time, the slots full and the list
    taking the rest (rows of one word; of two at D = 1)."""
    rng = np.random.default_rng(6500 + D)
    n, W = 3 * T + 77, 2 if D == 1 else 1
    codes, wps = _scan_codes(rng, n, D, W, miss=0.0)
    assert (codes >= 0).all()
    spilled = _check_scan(tiles_cxx, D, n, W, codes, wps, n // (2 * D), n + 1)
    assert spilled > 0


def _heads(case, D, cap, rng):
    """Headers of D slot blocks of cap rows for a live-row map case."""
    if case == "none":
        return np.zeros(D, np.int64)
    if case == "empty":  # every other block empty
        return np.where(np.arange(D) % 2 == 1, 0, rng.integers(1, cap + 1, D))
    if case == "at_cap":
        return np.full(D, cap)
    if case == "past_cap":  # headers past cap count cap rows
        return np.where(np.arange(D) % 2 == 0, cap + rng.integers(1, 1000, D), cap // 2)
    return rng.integers(0, 40, D)  # short: a tile straddles two and three blocks


@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("case", ["none", "empty", "at_cap", "past_cap", "short"])
@pytest.mark.parametrize("D", [1, 4, 16])
def test_live_row_map(tiles_cxx, D, case, tile):
    """The live rows of D slot blocks as a launch's lanes (route.cuh
    live_rows, block_starts and lane_block): K4's slot entry cuts each
    block's rows into whole tiles of `tile` lanes (a warp's step tile: 64
    lanes up to ref_k 128, 32 past it), so that no tile holds two blocks'
    rows; K7 packs them block after block, so that its tiles straddle
    blocks (two, and three at D = 16, in the short case).  Both maps give
    every live row once, in block and row order: empty blocks, headers at
    and past cap, short blocks, no live row at all."""
    rng = np.random.default_rng(7000 + 10 * D + len(case) + tile)
    cap = 50 if case == "short" else 3 * tile + 5
    heads = _heads(case, D, cap, rng)
    if case == "short" and D == 16:
        heads[:4] = [40, 10, 5, 30]  # lanes 32-63 lie in blocks 0-3
    live = np.minimum(heads, cap)
    want_b = np.repeat(np.arange(D), live)
    want_r = np.concatenate([np.arange(x) for x in live]) if live.sum() else np.zeros(0, int)
    maps = [np.full(int(live.sum()) + 1, 0xFFFFFFFF, np.uint32) for _ in range(4)]
    n = tiles_cxx.live_maps(_u32(heads).ctypes.data, D, cap, tile, *(m.ctypes.data for m in maps))
    assert n == live.sum()
    for got_b, got_r in (maps[:2], maps[2:]):
        np.testing.assert_array_equal(got_b[:n], want_b)
        np.testing.assert_array_equal(got_r[:n], want_r)
        assert got_b[n] == 0xFFFFFFFF
    if case == "short" and D > 1:  # K7's tiles across two blocks, and three at D = 16
        spans = max(len(set(want_b[f : f + tile])) for f in range(0, n, tile))
        assert spans >= (3 if D == 16 else 2)
