"""K5's lane split (malva_tpu_torch/csrc/gather.cuh) built for the host
with g++, a launch emulated, against the plain version bit for bit
(tolerance zero: counters and map values are integers).

The harness runs shard_step.cu's gather_update_kernel warp by warp with
the same functions: each warp takes its tiles of kGatherTile lanes in
turn (the tiles dealt round the warps as the persistent grid deals them),
classifies each lane from its centre hash (gather_lane), builds the warp's
two ballots and queues each lane where its ballot ranks it (enqueue, the
32 lanes one after another), and runs a pass whenever a queue holds 32
entries, then the rest after its last tile: each pass's owned lanes gather
their rows and add (gather_counter), its candidates load both buckets and
probe them (load_bucket, probe_pair).  The lanes are made on their centre
planes directly, so that a tile can be all owned, all candidates, none or
mixed, and some candidates carry a key of one of their buckets.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from malva_tpu_torch.index.kmap_table import bucket_pair_np
from malva_tpu_torch.ops import kernels
from malva_tpu_torch.ops.bloom import from_u32, to_u32
from malva_tpu_torch.parallel.sharded_index import shard_index
from malva_tpu_torch.utils.config import Config
from test_sharded import _index
from test_torch_lanes import CSRC

HARNESS_CXX = r"""
#include <stdint.h>
#include <vector>
#include "gather.cuh"
using namespace malva;

extern "C" int gather_tile() { return kGatherTile; }

// One launch of gather_update_kernel over n_warps warps; out gets the
// owned and the candidate entries the passes took.
template <int WK>
static void emulate(const uint32_t* centre, const uint32_t* cnt, const uint8_t* known, int64_t B,
                    const uint32_t* rows, int64_t word_base, int64_t n_words,
                    const uint32_t* keys, uint64_t n_buckets, uint64_t bucket_base,
                    uint64_t n_local, uint32_t* state, int64_t counts_len, uint64_t size_bits,
                    int n_warps, int64_t* out) {
  const int64_t n_tiles = (B + kGatherTile - 1) / kGatherTile;
  for (int warp = 0; warp < n_warps; ++warp) {
    GatherQueues q;
    uint32_t r_head = 0, r_n = 0, c_head = 0, c_n = 0;
    auto pass = [&](uint32_t n_r, uint32_t n_c) {
      for (int lane = 0; lane < 32; ++lane) {
        const uint32_t er = (r_head + lane) & (kGatherRing - 1);
        const uint32_t ec = (c_head + lane) & (kGatherRing - 1);
        if ((uint32_t)lane < n_r) {
          const int64_t at = gather_counter(rows[2 * (int64_t)q.row[er]],
                                            rows[2 * (int64_t)q.row[er] + 1], q.bk[er]);
          if (at >= 0) state[at] += q.rcnt[er];
          ++out[0];
        }
        if ((uint32_t)lane < n_c) {
          const uint32_t lb[2] = {q.lb1[ec], q.lb2[ec]};
          uint32_t can[WK], w[2][kSlots * WK];
          for (int j = 0; j < WK; ++j) can[j] = centre[(2 + j) * B + q.lane[ec]];
          load_bucket<WK>(keys, lb[0], w[0]);
          load_bucket<WK>(keys, lb[1], w[1]);
          const int64_t slot = probe_pair<WK>(w, can, lb);
          if (slot >= 0) state[counts_len + slot] += q.pcnt[ec];
          ++out[1];
        }
      }
      r_head += n_r;
      r_n -= n_r;
      c_head += n_c;
      c_n -= n_c;
    };
    for (int64_t t = warp; t < n_tiles; t += n_warps) {
      for (int r = 0; r < kGatherLanes; ++r) {
        GatherLane g[32];
        uint32_t c32[32] = {}, owned = 0, cand = 0;
        bool kn[32] = {};
        for (int lane = 0; lane < 32; ++lane) {
          const int64_t i = t * kGatherTile + r * 32 + lane;
          uint64_t c = 0;
          if (i < B) {
            c32[lane] = cnt[i];
            c = (uint64_t)centre[i] << 32 | centre[B + i];
            kn[lane] = known[i] != 0;
          }
          g[lane] = gather_lane(c, size_bits, word_base, n_words, n_buckets, bucket_base,
                                n_local, 0);
          g[lane].owned = g[lane].owned && c32[lane] != 0;
          g[lane].cand = g[lane].cand && c32[lane] != 0;
          owned |= (uint32_t)g[lane].owned << lane;
          cand |= (uint32_t)g[lane].cand << lane;
        }
        for (int lane = 0; lane < 32; ++lane)
          enqueue(q, g[lane], c32[lane], kn[lane], (uint32_t)(t * kGatherTile + r * 32 + lane),
                  owned, cand, lane, r_head + r_n, c_head + c_n);
        r_n += popc32(owned);
        c_n += popc32(cand);
        if (r_n > (uint32_t)kGatherRing || c_n > (uint32_t)kGatherRing) out[2] = 1;
      }
      while (r_n >= 32 || c_n >= 32) pass(r_n >= 32 ? 32 : 0, c_n >= 32 ? 32 : 0);
    }
    while (r_n || c_n) pass(r_n < 32 ? r_n : 32, c_n < 32 ? c_n : 32);
  }
}

extern "C" void emulate_launch(const uint32_t* centre, const uint32_t* cnt, const uint8_t* known,
                               int64_t B, int w_k, const uint32_t* rows, int64_t word_base,
                               int64_t n_words, const uint32_t* keys, uint64_t n_buckets,
                               uint64_t bucket_base, uint64_t n_local, uint32_t* state,
                               int64_t counts_len, uint64_t size_bits, int n_warps,
                               int64_t* out) {
  if (w_k == 3)
    emulate<3>(centre, cnt, known, B, rows, word_base, n_words, keys, n_buckets, bucket_base,
               n_local, state, counts_len, size_bits, n_warps, out);
}
"""


@pytest.fixture(scope="module")
def tiles_cxx(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("gather_tiles")
    (d / "tiles.cpp").write_text(HARNESS_CXX)
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas",
                    f"-I{CSRC}", "-o", str(d / "tiles.so"), str(d / "tiles.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "tiles.so"))
    p, i, i64, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint64
    lib.emulate_launch.argtypes = [p, p, p, i64, i, p, i64, i64, p, u64, u64, u64, p, i64, u64,
                                   i, p]
    return lib


SHARDS = 4
SHARD = 1
# (case, lanes, warps): the kind of every lane (mixed: each kind at random)
CASES = [("owned", 640, 3), ("candidates", 640, 3), ("none", 640, 3), ("mixed", 1000, 1),
         ("mixed", 4000, 5), ("mixed", 63, 2), ("mixed", 0, 2)]


def _lanes(case: str, n: int, gathered, seed: int):
    """n lanes of the kind `case` for shard SHARD: their (2 + w_k, n)
    centre planes (uint32), counters (a tenth zero, which adds nothing
    anywhere) and merged flags; an owned lane in two has its Bloom bit set,
    and a candidate in three carries the key of a slot of one of its
    buckets as its canonical centre."""
    bits = 1 << 20
    wps, nbps = gathered.words_per_shard, gathered.buckets_per_shard
    rows = to_u32(gathered.shards[SHARD].bf_packed)
    keys = to_u32(gathered.shards[SHARD].kmap_keys)
    rng = np.random.default_rng(seed)

    def kinds(c):
        owner = ((c % np.uint64(bits)) >> np.uint64(5)).astype(np.int64) // wps
        b1, b2 = bucket_pair_np((c & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                                (c >> np.uint64(32)).astype(np.uint32), gathered.n_buckets)
        l1, l2 = b1.astype(np.int64) - SHARD * nbps, b2.astype(np.int64) - SHARD * nbps
        in1, in2 = (l1 >= 0) & (l1 < nbps), (l2 >= 0) & (l2 < nbps)
        return owner == SHARD, in1, in2, l1, l2

    pool = rng.integers(0, 1 << 64, size=64 * n + 64, dtype=np.uint64)
    # an owned lane in two moved onto a set Bloom bit of the shard (its low
    # 20 bits), where that keeps its kind
    word = rows[:, 0].astype(np.uint64)
    set_bits = np.nonzero((word[:, None] >> np.arange(32, dtype=np.uint64)) & np.uint64(1))
    set_idx = ((SHARD * wps + set_bits[0]) * 32 + set_bits[1]).astype(np.uint64)
    moved = (pool & ~np.uint64(bits - 1)) | set_idx[rng.integers(0, set_idx.shape[0], pool.shape)]
    before, after = kinds(pool), kinds(moved)
    keep = (before[0] & (before[1] | before[2]) == after[0] & (after[1] | after[2])) & after[0]
    pool = np.where(keep & (rng.random(pool.shape) < 0.5), moved, pool)
    owned, in1, in2, l1, l2 = kinds(pool)
    cand = in1 | in2
    take = {"owned": owned & ~cand, "candidates": cand & ~owned, "none": ~owned & ~cand,
            "mixed": np.ones_like(owned)}[case]
    c = pool[take][:n]
    assert c.shape[0] == n
    planes = np.zeros((5, n), dtype=np.uint32)
    planes[0], planes[1] = (c >> np.uint64(32)).astype(np.uint32), c.astype(np.uint32)
    planes[2:] = rng.integers(0, 1 << 32, size=(3, n), dtype=np.uint64).astype(np.uint32)
    c_in1, c_in2 = in1[take][:n], in2[take][:n]
    plant = (c_in1 | c_in2) & (rng.random(n) < 1 / 3)
    lb = np.where(c_in1 & (~c_in2 | (rng.random(n) < 0.5)), l1[take][:n], l2[take][:n])
    slot = rng.integers(0, 4, n)
    for i in np.nonzero(plant)[0]:
        planes[2:, i] = keys[lb[i], 3 * slot[i] : 3 * slot[i] + 3]
    counters = rng.integers(1, 256, n).astype(np.uint32)
    counters[rng.random(n) < 0.1] = 0
    known = rng.random(n) < 0.5
    return planes, counters, known


@pytest.mark.parametrize("case,n,warps", CASES)
def test_gather_launch_matches_plain(tiles_cxx, case, n, warps):
    """An emulated K5 launch (gather.cuh's queues, warp by warp) over tiles
    of all owned lanes, all candidates, none and mixed, a batch that is not
    a whole number of tiles and an empty one, == gather_update_plain; every
    owned lane and every candidate with a counter is taken by exactly one
    pass, and no queue outgrows its ring."""
    cfg = Config(k=35, ref_k=43, bf_size=1 << 20)
    index, _ = _index(cfg, seed=3)
    gathered = shard_index(index, cfg, ["cpu"] * SHARDS)
    sh = gathered.shards[SHARD]
    wps, nbps = gathered.words_per_shard, gathered.buckets_per_shard
    planes, counters, known = _lanes(case, n, gathered, seed=n + warps)
    kw = dict(k=35, size_bits=cfg.bf_size, n_buckets=gathered.n_buckets,
              word_base=SHARD * wps, bucket_base=SHARD * nbps, counts_len=gathered.cmax)
    want = sh.state.clone()
    kernels.gather_update_plain(sh.bf_packed, sh.kmap_keys, want, from_u32(planes, "cpu"),
                                from_u32(counters, "cpu"), torch.from_numpy(known), **kw)
    got = to_u32(sh.state).copy()
    rows, keys = to_u32(sh.bf_packed), to_u32(sh.kmap_keys)
    out = np.zeros(3, dtype=np.int64)
    known_u8 = known.astype(np.uint8)
    tiles_cxx.emulate_launch(planes.ctypes.data, counters.ctypes.data, known_u8.ctypes.data, n,
                             3, rows.ctypes.data, SHARD * wps, wps, keys.ctypes.data,
                             gathered.n_buckets, SHARD * nbps, nbps, got.ctypes.data,
                             gathered.cmax, cfg.bf_size, warps, out.ctypes.data)
    np.testing.assert_array_equal(got, to_u32(want))
    c = planes[0].astype(np.uint64) << np.uint64(32) | planes[1]
    owner = ((c % np.uint64(cfg.bf_size)) >> np.uint64(5)).astype(np.int64) // wps
    b1, b2 = bucket_pair_np(planes[1], planes[0], gathered.n_buckets)
    cand = ((b1 // nbps == SHARD) | (b2 // nbps == SHARD)) & (counters != 0)
    assert out[0] == int(((owner == SHARD) & (counters != 0)).sum())
    assert out[1] == int(cand.sum()) and out[2] == 0
    if case in ("owned", "candidates", "mixed") and n >= 640:
        touched = got != to_u32(sh.state)
        assert touched[: gathered.cmax].any() == (case != "candidates")
        assert touched[gathered.cmax :].any() == (case != "owned")
