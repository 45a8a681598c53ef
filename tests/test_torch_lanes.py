"""The per-lane math of K1, K2, K4 and K5 (malva_tpu_torch/csrc/lanes.cuh,
gather.cuh and xxh3.cuh) built for the host with g++, against the port's
plain versions, bit for bit (tolerance zero: integer hashing and keys).

The plain versions are held against the Pallas kernels in interpret mode
by tests/test_torch_callstep.py and tests/test_torch_ref_scan.py."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from malva_tpu_torch.index.device import pack2bit_u32_np
from malva_tpu_torch.index.kmap_table import BucketTable, probe_bucket_table
from malva_tpu_torch.ops import kernels
from malva_tpu_torch.ops.bloom import from_u32
from malva_tpu_torch.ops.packed import decode_byte_cols
from malva_tpu_torch.ops.seq import canonical
from malva_tpu_torch.ops.xxh3 import xxh3_64
from test_torch_ref_scan import ALPHABETS

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "malva_tpu_torch", "csrc")
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)

# Host drivers of the per-lane helpers.  window_scan cuts the chunk into
# tiles as K2's blocks do: a tile's bytes and ref_k - 1 halo bytes in
# words (garbage past the chunk), the RCN-reversed copy built a word at a
# time, then the centre and window hashes of each position from the two.
HARNESS_CXX = r"""
#include <string.h>
#include <vector>
#include "gather.cuh"
using namespace malva;

#define CASES(F) F(1) F(2) F(3) F(4) F(5) F(6) F(7) F(8) F(9) F(10) F(11) F(12) F(13) F(14) F(15)

extern "C" void hash_bytes(const uint8_t* rows, int64_t n, int stride, int len, uint64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = xxh3_64(BytePtr{rows + i * stride}, len);
}

extern "C" void hash_words(const uint32_t* words, int64_t n, int stride, int start, int len,
                           uint64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = xxh3_64(WordBytes{words + i * stride, start}, len);
}

template <int N>
static void hash_packed_n(const uint32_t* w, int64_t n, int len, uint64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t r[N];
    memcpy(r, w + i * N, sizeof r);
    out[i] = xxh3_64(PackedBases<N>(r), len);
  }
}

extern "C" void hash_packed(const uint32_t* w, int64_t n, int nw, int len, uint64_t* out) {
  switch (nw) {
#define F(m) case m: hash_packed_n<m>(w, n, len, out); break;
    CASES(F)
#undef F
  }
}

// K1's hash-only planes: [x_hi, x_lo,] c_hi, c_lo, can_0 .. can_{w_k - 1}
template <int N>
static void callstep_front_n(const uint32_t* ctx, int64_t B, int k, int ref_k, int with_ctx,
                             uint32_t* out) {
  for (int64_t i = 0; i < B; ++i) {
    uint32_t w[N], can[N];
    memcpy(w, ctx + i * N, sizeof w);
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
    for (int j = 0; j < (k + 15) / 16; ++j) out[(at + 2 + j) * B + i] = can[j];
  }
}

extern "C" void callstep_front(const uint32_t* ctx, int64_t B, int wc, int k, int ref_k,
                               int with_ctx, uint32_t* out) {
  switch (wc) {
#define F(m) case m: callstep_front_n<m>(ctx, B, k, ref_k, with_ctx, out); break;
    CASES(F)
#undef F
  }
}

extern "C" void window_scan(const uint8_t* seq, int64_t n_pos, int k, int ref_k, int tile,
                            uint32_t* out) {
  uint8_t table[256];
  for (int i = 0; i < 256; ++i) table[i] = rcn((uint8_t)i);
  const int64_t n_bytes = n_pos + ref_k - 1;
  const int want = tile + ref_k - 1, off = (ref_k - k) / 2;
  std::vector<uint32_t> fwd((want + 3) / 4 + 3), rev(fwd.size());
  for (int64_t start = 0; start < n_pos; start += tile) {
    const int L = n_bytes - start < want ? (int)(n_bytes - start) : want;
    const int E = (L + 3) & ~3;
    memset(fwd.data(), 0xA5, fwd.size() * 4);
    memset(rev.data(), 0x5A, rev.size() * 4);
    memcpy(fwd.data(), seq + start, L);
    for (int q = 0; q < E / 4; ++q) rev[q] = rcn_reverse4(fwd[E / 4 - 1 - q], table);
    for (int p = 0; p < tile && start + p < n_pos; ++p) {
      const uint64_t c = window_hash_at(fwd.data(), rev.data(), E, p + off, k);
      const uint64_t x = window_hash_at(fwd.data(), rev.data(), E, p, ref_k);
      const int64_t g = start + p;
      out[g] = (uint32_t)(c >> 32);
      out[n_pos + g] = (uint32_t)c;
      out[2 * n_pos + g] = (uint32_t)(x >> 32);
      out[3 * n_pos + g] = (uint32_t)x;
    }
  }
}

template <int N>
static void probe_n(const uint32_t* keys, uint64_t n_buckets, int w_k, const uint32_t* can,
                    const uint64_t* h, int64_t B, int64_t* out) {
  for (int64_t i = 0; i < B; ++i) {
    uint32_t c[N] = {};
    memcpy(c, can + i * w_k, 4 * w_k);
    out[i] = probe_buckets(keys, n_buckets, w_k, c, h[i]);
  }
}

// K4 lane by lane: step.cuh's step_body without its warp machinery (the
// centre hash, the shard's row and row_test, hop 1's "known" flag, the
// probe), adding into `state` in lane order.
template <int N>
static void shard_lanes_n(const uint32_t* ctx, const uint32_t* cnt, const uint8_t* known,
                          int64_t B, int k, int ref_k, const uint32_t* rows, int64_t word_base,
                          int64_t n_words, const uint32_t* keys, uint64_t n_buckets,
                          uint32_t* state, int64_t counts_len, uint64_t size_bits,
                          int minifilter) {
  const bool use_mf = minifilter && n_buckets > 1;
  for (int64_t i = 0; i < B; ++i) {
    if (!cnt[i]) continue;
    uint32_t w[N], can[N];
    memcpy(w, ctx + i * N, sizeof w);
    const uint64_t c = centre_hash(w, k, ref_k, can);
    const int64_t lw = (int64_t)(bloom_index(c, size_bits) >> 5) - word_base;
    if (lw < 0 || lw >= n_words) continue;
    const RowTest t = row_test(rows[2 * lw], rows[2 * lw + 1], c, size_bits, minifilter, use_mf);
    if ((t.what & 1u) && !known[i]) state[t.cidx] += cnt[i];
    if (t.what & 2u) {
      const int64_t slot = probe_buckets(keys, n_buckets, (k + 15) / 16, can, c);
      if (slot >= 0) state[counts_len + slot] += cnt[i];
    }
  }
}

extern "C" void shard_lanes(const uint32_t* ctx, const uint32_t* cnt, const uint8_t* known,
                            int64_t B, int wc, int k, int ref_k, const uint32_t* rows,
                            int64_t word_base, int64_t n_words, const uint32_t* keys,
                            uint64_t n_buckets, uint32_t* state, int64_t counts_len,
                            uint64_t size_bits, int minifilter) {
  switch (wc) {
#define F(m) case m: shard_lanes_n<m>(ctx, cnt, known, B, k, ref_k, rows, word_base, n_words, \
                                      keys, n_buckets, state, counts_len, size_bits, minifilter); \
                     break;
    CASES(F)
#undef F
  }
}

// K5 lane by lane (gather.cuh): from K1 hash-only's centre planes, what
// the lane does on the shard (gather_lane); where its Bloom word is the
// shard's, its counter add (gather_counter with the merged "known" flag);
// where a bucket is, both buckets loaded and probed (load_bucket,
// probe_pair); adding into `state` in lane order.
template <int WK>
static void gather_lanes_n(const uint32_t* centre, const uint32_t* cnt, const uint8_t* known,
                           int64_t B, const uint32_t* rows, int64_t word_base, int64_t n_words,
                           const uint32_t* keys, uint64_t n_buckets, uint64_t bucket_base,
                           uint64_t n_local, uint32_t* state, int64_t counts_len,
                           uint64_t size_bits) {
  for (int64_t i = 0; i < B; ++i) {
    if (!cnt[i]) continue;
    const uint64_t c = (uint64_t)centre[i] << 32 | centre[B + i];
    const GatherLane g =
        gather_lane(c, size_bits, word_base, n_words, n_buckets, bucket_base, n_local, 0);
    if (g.owned) {
      const int64_t at = gather_counter(rows[2 * (int64_t)g.row], rows[2 * (int64_t)g.row + 1],
                                        g.bit | (uint32_t)(known[i] != 0) << 5);
      if (at >= 0) state[at] += cnt[i];
    }
    if (g.cand) {
      uint32_t can[WK], w[2][kSlots * WK];
      for (int j = 0; j < WK; ++j) can[j] = centre[(2 + j) * B + i];
      load_bucket<WK>(keys, g.lb[0], w[0]);
      load_bucket<WK>(keys, g.lb[1], w[1]);
      const int64_t slot = probe_pair<WK>(w, can, g.lb);
      if (slot >= 0) state[counts_len + slot] += cnt[i];
    }
  }
}

extern "C" void gather_lanes(const uint32_t* centre, const uint32_t* cnt, const uint8_t* known,
                             int64_t B, int w_k, const uint32_t* rows, int64_t word_base,
                             int64_t n_words, const uint32_t* keys, uint64_t n_buckets,
                             uint64_t bucket_base, uint64_t n_local, uint32_t* state,
                             int64_t counts_len, uint64_t size_bits) {
  switch (w_k) {
#define F(m) case m: gather_lanes_n<m>(centre, cnt, known, B, rows, word_base, n_words, keys, \
                                       n_buckets, bucket_base, n_local, state, counts_len, \
                                       size_bits); \
                     break;
    CASES(F)
#undef F
  }
}

extern "C" void probe(const uint32_t* keys, uint64_t n_buckets, int w_k, int nw,
                      const uint32_t* can, const uint64_t* h, int64_t B, int64_t* out) {
  switch (nw) {
#define F(m) case m: probe_n<m>(keys, n_buckets, w_k, can, h, B, out); break;
    CASES(F)
#undef F
  }
}
"""


@pytest.fixture(scope="module")
def lanes_cxx(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("lanes")
    (d / "lanes.cpp").write_text(HARNESS_CXX)
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas",
                    f"-I{CSRC}", "-o", str(d / "lanes.so"), str(d / "lanes.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "lanes.so"))
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.hash_bytes.argtypes = [p, i64, i, i, p]
    lib.hash_words.argtypes = [p, i64, i, i, i, p]
    lib.hash_packed.argtypes = [p, i64, i, i, p]
    lib.callstep_front.argtypes = [p, i64, i, i, i, i, p]
    lib.window_scan.argtypes = [p, i64, i, i, i, p]
    lib.probe.argtypes = [p, ctypes.c_uint64, i, i, p, p, i64, p]
    lib.shard_lanes.argtypes = [p, p, p, i64, i, i, i, p, i64, i64, p, ctypes.c_uint64, p, i64,
                                ctypes.c_uint64, i]
    u64 = ctypes.c_uint64
    lib.gather_lanes.argtypes = [p, p, p, i64, i, p, i64, i64, p, u64, u64, u64, p, i64, u64]
    return lib


def _hash_rows(lib, reader: str, rng, length: int, n: int = 24) -> tuple:
    """(XXH3 through `reader`, numpy XXH3 of the same bytes) of n rows."""
    out = np.zeros(n, dtype=np.uint64)
    if reader == "packed":
        nw = min(15, max(1, -(-length // 16)) + int(rng.integers(0, 2)))
        words = rng.integers(0, 1 << 32, size=(n, nw), dtype=np.uint64).astype(np.uint32)
        cols = decode_byte_cols([torch.from_numpy(words[:, j].astype(np.int64))
                                 for j in range(nw)], length)
        data = (torch.stack(cols, 1).numpy().astype(np.uint8) if cols
                else np.zeros((n, 0), np.uint8))
        lib.hash_packed(words.ctypes.data, n, nw, length, out.ctypes.data)
        return out, xxh3_64(data)
    data = rng.integers(0, 256, size=(n, length), dtype=np.uint64).astype(np.uint8)
    if reader == "bytes":
        lib.hash_bytes(data.ctypes.data, n, length, length, out.ctypes.data)
    else:  # aligned words, the row from byte `start` on, garbage around it
        start = int(rng.integers(0, 4))
        stride = (start + length + 12 + 3) // 4
        buf = rng.integers(0, 256, size=(n, 4 * stride), dtype=np.uint64).astype(np.uint8)
        buf[:, start : start + length] = data
        lib.hash_words(buf.ctypes.data, n, stride, start, length, out.ctypes.data)
    return out, xxh3_64(data)


@pytest.mark.parametrize("reader", ["bytes", "words", "packed"])
def test_xxh3_reader_matches_spec(lanes_cxx, reader):
    """XXH3_64 through each reader == the numpy spec on the same bytes, for
    every length 0..240 (the packed reader: the ASCII of the bases, with
    garbage bits past the length and a spare word at random)."""
    rng = np.random.default_rng(len(reader))
    for length in range(241):
        got, want = _hash_rows(lanes_cxx, reader, rng, length)
        np.testing.assert_array_equal(got, want, err_msg=f"{reader} reader, length {length}")


def _contexts(rng, n: int, k: int, ref_k: int) -> np.ndarray:
    """n packed contexts of ref_k bases (random bits past ref_k), a few
    with a palindromic centre where k is even."""
    wc = (ref_k + 15) // 16
    ctx = rng.integers(0, 1 << 32, size=(n, wc), dtype=np.uint64).astype(np.uint32)
    if k % 2 == 0:
        off = (ref_k - k) // 2
        rows = ACGT[rng.integers(0, 4, size=(64, ref_k))]
        half = rng.integers(0, 4, size=(64, k // 2))
        rows[:, off : off + k] = ACGT[np.concatenate([half, 3 - half[:, ::-1]], axis=1)]
        ctx[:64] = pack2bit_u32_np(rows, ref_k)
    return ctx


@pytest.mark.parametrize("with_ctx", [False, True])
@pytest.mark.parametrize("k,ref_k", [(35, 43), (15, 31), (31, 33), (61, 65), (100, 240)])
def test_callstep_front_matches_plain(lanes_cxx, k, ref_k, with_ctx):
    """K1's per-lane front end (canonical centre in registers, XXH3 through
    the 2-bit reader; the context hash) == callstep_hash_plain."""
    rng = np.random.default_rng(k * 1000 + ref_k + with_ctx)
    ctx = _contexts(rng, 3000, k, ref_k)
    B, wc = ctx.shape
    want = kernels.callstep_hash_plain(from_u32(ctx, "cpu"), k, ref_k, with_ctx)
    got = np.zeros((len(want), B), dtype=np.uint32)
    lanes_cxx.callstep_front(ctx.ctypes.data, B, wc, k, ref_k, int(with_ctx), got.ctypes.data)
    for j, w in enumerate(want):
        np.testing.assert_array_equal(got[j], w.numpy().astype(np.uint32), err_msg=f"plane {j}")


def _palindromic_chunk(rng, n_bytes: int, k: int, ref_k: int) -> np.ndarray:
    """ACGT with windows whose reverse complement is themselves planted:
    ACGT palindromes for even lengths, an N between a half and its reverse
    complement for odd ones (N complements to N)."""
    seq = ACGT[rng.integers(0, 4, n_bytes)]
    off = (ref_k - k) // 2
    for at in range(3, n_bytes - ref_k, 97):
        for start, n in ((at, ref_k), (at + off, k)):
            half = rng.integers(0, 4, n // 2)
            mid = [] if n % 2 == 0 else [ord("N")]
            seq[start : start + n] = np.concatenate([ACGT[half], mid, ACGT[3 - half[::-1]]])
    return seq


@pytest.mark.parametrize("k,ref_k", [(35, 43), (16, 32)])
@pytest.mark.parametrize("alphabet", sorted(ALPHABETS) + ["palindromes"])
def test_window_scan_matches_plain(lanes_cxx, alphabet, k, ref_k):
    """K2's per-position path over emulated tiles (a tile of the kernel's
    2048 positions and one of 333, neither dividing the chunk), from an
    aligned and an unaligned start, == window_hash_plain."""
    rng = np.random.default_rng(len(alphabet) + k)
    n_pos = 5000 + ref_k
    if alphabet == "palindromes":
        chunk = _palindromic_chunk(rng, n_pos + ref_k, k, ref_k)
        win = np.lib.stride_tricks.sliding_window_view(chunk, ref_k)[3]
        assert (canonical(win[None, :]) == win).all()
    else:
        alpha = np.frombuffer(ALPHABETS[alphabet], dtype=np.uint8)
        chunk = alpha[rng.integers(0, alpha.shape[0], n_pos + ref_k)]
    for seq in (chunk[:-1], chunk[1:]):
        seq = np.ascontiguousarray(seq)
        want = kernels.window_hash_plain(torch.from_numpy(seq), n_pos, k, ref_k)
        for tile in (2048, 333):
            got = np.zeros((4, n_pos), dtype=np.uint32)
            lanes_cxx.window_scan(seq.ctypes.data, n_pos, k, ref_k, tile, got.ctypes.data)
            for j, w in enumerate(want):
                np.testing.assert_array_equal(got[j], w.numpy().astype(np.uint32),
                                              err_msg=f"plane {j}, tile {tile}")


@pytest.mark.parametrize("k,spare", [(35, 0), (35, 2), (16, 0), (16, 1), (61, 1)])
def test_register_probe_matches_plain(lanes_cxx, k, spare):
    """The register bucket probe (N = w_k + spare words, zeros past w_k, as
    K1 holds a centre in its context's word count) == probe_bucket_table,
    over keys in the map and random misses."""
    rng = np.random.default_rng(k + 10 * spare)
    keys = canonical(ACGT[rng.integers(0, 4, size=(3000, k))])
    keys = np.unique(keys, axis=0)
    packed = pack2bit_u32_np(keys, k)
    table = BucketTable.from_packed(packed, xxh3_64(keys), k)
    miss = canonical(ACGT[rng.integers(0, 4, size=(1000, k))])
    q = np.concatenate([keys, miss])
    q_packed = np.ascontiguousarray(pack2bit_u32_np(q, k))
    h = xxh3_64(q)
    w_k = (k + 15) // 16
    got = np.zeros(q.shape[0], dtype=np.int64)
    lanes_cxx.probe(table.bucket_keys.ctypes.data, table.n_buckets, w_k, w_k + spare,
                    q_packed.ctypes.data, h.ctypes.data, q.shape[0], got.ctypes.data)
    hi = torch.from_numpy((h >> np.uint64(32)).astype(np.int64))
    lo = torch.from_numpy((h & np.uint64(0xFFFFFFFF)).astype(np.int64))
    cols = [torch.from_numpy(q_packed[:, j].astype(np.int64)) for j in range(w_k)]
    slot, found = probe_bucket_table(from_u32(table.bucket_keys, "cpu"), table.n_buckets, w_k,
                                     cols, hi, lo)
    want = torch.where(found, slot, -1).numpy()
    assert (want[: keys.shape[0]] >= 0).all() and (want < 0).any()
    np.testing.assert_array_equal(got, want)


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115callstep_kernelILi3EEEvPKjS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115callstep_kernelILi3EEEvPKjS2_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 16384 bytes smem, 448 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120callstep_hash_kernelILi3EEEvPKj' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120callstep_hash_kernelILi3EEEvPKj
    240 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z6helperv' for 'sm_90a'
ptxas info    : Used 2 registers
"""


def test_ptxas_report_reads_each_kernel():
    """_build.ptxas_report: one entry per compiled kernel, with its kernel
    name, registers, stack frame and spills."""
    from malva_tpu_torch.ops import _build

    rep = _build.ptxas_report(PTXAS_LOG)
    assert [(r["kernel"], r["registers"], r["stack"], r["spill_stores"], r["spill_loads"])
            for r in rep] == [("callstep_kernel", 72, 0, 0, 0),
                              ("callstep_hash_kernel", 40, 240, 8, 4), (None, 2, 0, 0, 0)]
    assert _build.ptxas_report("") == []


@pytest.mark.parametrize("minifilter", [True, False])
@pytest.mark.parametrize("shard", [0, 3])
def test_shard_lanes_match_plain(lanes_cxx, shard, minifilter):
    """K4's per-lane path (lanes.cuh centre_hash, row_test and the register
    probe, with hop 1's "known" flags) on one shard of a 4-shard index, its
    rows with the shard's mini-filter and without it, == shard_update_plain
    over lanes of every shard (the others are no-ops)."""
    from malva_tpu_torch.index.device import RANK_MASK
    from malva_tpu_torch.ops.bloom import to_u32
    from malva_tpu_torch.parallel.sharded_index import shard_index_routed
    from malva_tpu_torch.utils.config import Config
    from test_sharded import _index
    from test_torch_sharded import _contexts

    cfg = Config(k=35, ref_k=43, bf_size=1 << 20)
    index, keys = _index(cfg, seed=14)
    sharded = shard_index_routed(index, cfg, ["cpu"] * 4)
    sh = sharded.shards[shard]
    rows = sh.bf_packed.clone()
    if not minifilter:
        rows[:, 1] &= RANK_MASK
    contexts, counters = _contexts(keys, seed=15 + shard, n=4000)
    ctx = pack2bit_u32_np(contexts, 43)
    known = np.random.default_rng(shard).random(ctx.shape[0]) < 0.5
    wps = sharded.words_per_shard
    kw = dict(k=35, ref_k=43, size_bits=cfg.bf_size, n_buckets=sharded.nbs,
              word_base=shard * wps, counts_len=sharded.cmax, minifilter=minifilter)
    want = sh.state.clone()
    kernels.shard_update_plain(rows, sh.kmap_keys, want, from_u32(ctx, "cpu"),
                               from_u32(counters, "cpu"), torch.from_numpy(known), **kw)
    got = to_u32(sh.state)
    rows_u32, keys_u32 = to_u32(rows), to_u32(sh.kmap_keys)
    known_u8 = known.astype(np.uint8)
    lanes_cxx.shard_lanes(ctx.ctypes.data, counters.ctypes.data, known_u8.ctypes.data,
                          ctx.shape[0], ctx.shape[1], 35, 43, rows_u32.ctypes.data, shard * wps,
                          wps, keys_u32.ctypes.data, sharded.nbs, got.ctypes.data,
                          sharded.cmax, cfg.bf_size, int(minifilter))
    np.testing.assert_array_equal(got, to_u32(want))
    assert got[: sharded.cmax].any() and got[sharded.cmax :].any()


@pytest.mark.parametrize("shard", [0, 3])
def test_gather_lanes_match_plain(lanes_cxx, shard):
    """K5's per-lane path (gather.cuh: the lane's owned row and buckets in
    the shard's range from its centre hash, the counter add with the
    merged "known" flag, both buckets loaded then probed, bucket 1 first)
    on one shard of a 4-shard all-gather index, over every lane of the
    batch as K1 hash-only's planes, == gather_update_plain."""
    from malva_tpu_torch.ops.bloom import to_u32
    from malva_tpu_torch.parallel.sharded_index import shard_index
    from malva_tpu_torch.utils.config import Config
    from test_sharded import _index
    from test_torch_sharded import _contexts

    cfg = Config(k=35, ref_k=43, bf_size=1 << 20)
    index, keys = _index(cfg, seed=14)
    gathered = shard_index(index, cfg, ["cpu"] * 4)
    sh = gathered.shards[shard]
    contexts, counters = _contexts(keys, seed=25 + shard, n=4000)
    ctx = pack2bit_u32_np(contexts, 43)
    known = np.random.default_rng(shard).random(ctx.shape[0]) < 0.5
    wps, nbps = gathered.words_per_shard, gathered.buckets_per_shard
    kw = dict(k=35, size_bits=cfg.bf_size, n_buckets=gathered.n_buckets,
              word_base=shard * wps, bucket_base=shard * nbps, counts_len=gathered.cmax)
    centre = kernels.callstep_hash_words(from_u32(ctx, "cpu"), 35, 43, True)[2:]
    want = sh.state.clone()
    kernels.gather_update_plain(sh.bf_packed, sh.kmap_keys, want, centre,
                                from_u32(counters, "cpu"), torch.from_numpy(known), **kw)
    got = to_u32(sh.state)
    rows_u32, keys_u32 = to_u32(sh.bf_packed), to_u32(sh.kmap_keys)
    planes = np.ascontiguousarray(to_u32(centre))
    known_u8 = known.astype(np.uint8)
    lanes_cxx.gather_lanes(planes.ctypes.data, counters.ctypes.data, known_u8.ctypes.data,
                           ctx.shape[0], 3, rows_u32.ctypes.data, shard * wps, wps,
                           keys_u32.ctypes.data, gathered.n_buckets, shard * nbps, nbps,
                           got.ctypes.data, gathered.cmax, cfg.bf_size)
    np.testing.assert_array_equal(got, to_u32(want))
    assert got[: gathered.cmax].any() and got[gathered.cmax :].any()
