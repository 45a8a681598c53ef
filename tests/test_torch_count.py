"""The port's sample counting (K3 plain version + torch sort-count) against
the JAX package's device sort-count and its host counter, exactly: the
same keys, counts and order (tolerance zero: integer keys and counts)."""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from malva_tpu.count import counter as mc
from malva_tpu.count import spill as ms
from malva_tpu.count.device_count import device_seq_sorted_counts as jax_sorted_counts
from malva_tpu.count.device_count import make_seq_sort_count_step as jax_step
from malva_tpu.ops.seq import canonical, pack_2bit, revcomp, upper
from malva_tpu_torch.count import counter as tc
from malva_tpu_torch.count import device_count as tdc
from malva_tpu_torch.count import spill as ts
from malva_tpu_torch.ops import kernels

REF_KS = [16, 32, 43, 64]
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "malva_tpu_torch", "csrc")
QUIET = open(os.devnull, "w")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _read_chunk(rng, n_bytes: int, ref_k: int) -> np.ndarray:
    """Reads joined by 0xFF: mostly ACGT, with N, lowercase and reads
    shorter than ref_k."""
    alpha = np.frombuffer(b"ACGTACGTACGTACGTACGTNacgt", dtype=np.uint8)
    parts, n = [], 0
    while n < n_bytes:
        length = int(rng.integers(ref_k // 2, 3 * ref_k))
        parts += [alpha[rng.integers(0, alpha.shape[0], length)], np.full(1, 0xFF, np.uint8)]
        n += length + 1
    return np.concatenate(parts)[:n_bytes]


@pytest.mark.parametrize("ref_k", REF_KS)
@pytest.mark.parametrize("fill", ["full", "partial"])
def test_device_seq_sorted_counts_matches_jax(ref_k, fill):
    """Port step (raw and uppercased chunk) == JAX step on the uppercased
    chunk, for a full chunk and a partial last chunk."""
    chunk = 2048
    rng = np.random.default_rng(ref_k)
    n_bytes = chunk + ref_k - 1 if fill == "full" else chunk // 3
    seq = _read_chunk(rng, n_bytes, ref_k)
    want_k, want_c = jax_sorted_counts(jax_step(ref_k, chunk), upper(seq), chunk, ref_k)
    assert want_k.shape[0] > 10
    step = tdc.make_seq_sort_count_step(ref_k, chunk, "cpu")
    for s in (seq, upper(seq)):
        got_k, got_c = tdc.device_seq_sorted_counts(step, s)
        assert got_k.dtype == np.uint64 and got_c.dtype == np.int64
        np.testing.assert_array_equal(got_k, want_k)
        np.testing.assert_array_equal(got_c, want_c)


@pytest.mark.parametrize("ref_k", REF_KS + [1, 33, 100])
def test_seq_pack_plain_matches_host_pack(ref_k):
    """Plain K3: validity = all bytes ACGT (either case), key = host
    pack_2bit(canonical(window)), 0 for invalid windows."""
    rng = np.random.default_rng(ref_k + 7)
    alpha = np.frombuffer(b"ACGT" * 20 + b"acgtN\xff", dtype=np.uint8)
    seq = alpha[rng.integers(0, alpha.shape[0], 4000)]
    n_pos = seq.shape[0] - ref_k + 1
    keys, valid = kernels.seq_pack(torch.from_numpy(seq), n_pos, ref_k)
    win = np.lib.stride_tricks.sliding_window_view(upper(seq), ref_k)
    ok = np.isin(win, np.frombuffer(b"ACGT", dtype=np.uint8)).all(axis=1)
    np.testing.assert_array_equal(valid.numpy(), ok)
    assert ok.any()
    np.testing.assert_array_equal(keys.numpy().view(np.uint64)[ok], pack_2bit(canonical(win[ok])))
    assert not keys.numpy()[~ok].any()


def test_sort_count_rows_is_unsigned_order():
    """Words with the top bit set (first base G or T) sort after the rest."""
    words = np.array([[1 << 63, 5], [3, 9], [1 << 63, 5], [(1 << 64) - 1, 0], [3, 1 << 63],
                      [0, 0]], dtype=np.uint64)
    keys, counts = tdc.sort_count_rows(torch.from_numpy(words.view(np.int64)))
    want_k, want_c = mc._sorted_counts(words)
    np.testing.assert_array_equal(keys.numpy().view(np.uint64), want_k)
    np.testing.assert_array_equal(counts.numpy(), want_c)


# K3's per-window arithmetic (csrc/lanes.cuh base_codes4 and RollingKey)
# built for the host with g++: the chunk is translated four bytes at a
# time, then cut into runs of `seg` windows, each rolled as one thread of
# the kernel rolls its run (ref_k - 1 bases of warm-up, then one base per
# window).
ROLLING_CXX = r"""
#include <string.h>
#include <vector>
#include "lanes.cuh"
using namespace malva;

template <int N>
static void roll(const uint8_t* s, int64_t n_pos, int k, int64_t seg, uint64_t* keys,
                 uint8_t* valid) {
  const int64_t n_words = (n_pos + k - 1 + 3) / 4;  // the caller pads s to whole words
  std::vector<uint8_t> codes(4 * n_words);
  for (int64_t q = 0; q < n_words; ++q) {
    uint32_t w;
    memcpy(&w, s + 4 * q, 4);
    w = base_codes4(w);
    memcpy(&codes[4 * q], &w, 4);
  }
  const RollShape shape = roll_shape(k);
  for (int64_t s0 = 0; s0 < n_pos; s0 += seg) {
    RollingKey<N> st;
    st.reset();
    for (int m = 0; m < k - 1; ++m) st.push(codes[s0 + m], shape);
    for (int64_t p = s0; p < s0 + seg && p < n_pos; ++p) {
      st.push(codes[p + k - 1], shape);
      valid[p] = st.key(shape, keys + p * RollingKey<N>::W);
    }
  }
}

extern "C" void pack(const uint8_t* s, int64_t n_pos, int k, int64_t seg, uint64_t* keys,
                     uint8_t* valid) {
  switch ((k + 15) / 16) {
#define CASE(n) case n: roll<n>(s, n_pos, k, seg, keys, valid); break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9) CASE(10)
    CASE(11) CASE(12) CASE(13) CASE(14) CASE(15)
  }
}
"""


@pytest.fixture(scope="module")
def rolling_cxx(tmp_path_factory):
    import ctypes

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("k3")
    (d / "k3.cpp").write_text(ROLLING_CXX)
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas",
                    f"-I{CSRC}", "-o", str(d / "k3.so"), str(d / "k3.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "k3.so"))
    lib.pack.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_void_p, ctypes.c_void_p]

    def pack(seq: np.ndarray, n_pos: int, ref_k: int, seg: int):
        padded = np.zeros((seq.shape[0] + 3) // 4 * 4, dtype=np.uint8)
        padded[: seq.shape[0]] = seq
        keys = np.full((n_pos, (ref_k + 31) // 32), 0xA5A5A5A5, dtype=np.uint64)
        valid = np.full(n_pos, 9, dtype=np.uint8)
        lib.pack(padded.ctypes.data, n_pos, ref_k, seg, keys.ctypes.data, valid.ctypes.data)
        return keys, valid

    return pack


def _check_rolling(pack, seq: np.ndarray, n_pos: int, ref_k: int, segs):
    pk, pv = kernels.seq_pack_plain(torch.from_numpy(seq), n_pos, ref_k)
    assert pv.any()
    for seg in segs:
        keys, valid = pack(seq, n_pos, ref_k, seg)
        np.testing.assert_array_equal(valid, pv.numpy().astype(np.uint8))
        np.testing.assert_array_equal(keys, pk.numpy().view(np.uint64))


def test_canonical_window_cxx_matches_plain(rolling_cxx):
    """K3's per-window arithmetic (csrc/lanes.cuh, the rolling step, built
    for the host with g++) == the plain version, bit for bit."""
    rng = np.random.default_rng(3)
    alpha = np.frombuffer(b"ACGTACGTACGTACGTACGTacgtN\xff\xc1", dtype=np.uint8)
    for ref_k in (1, 15, 16, 17, 31, 32, 33, 43, 64, 65, 100, 240):
        seq = alpha[rng.integers(0, alpha.shape[0] if ref_k < 60 else 8, 5000)].copy()
        seq[2000] = ord("n")  # long windows need mostly ACGT to be valid at all
        _check_rolling(rolling_cxx, seq, seq.shape[0] - ref_k + 1, ref_k, (32, 5000))


def _ragged_chunk(rng, n_pos: int, ref_k: int) -> np.ndarray:
    """Reads joined by 0xFF, with N, IUPAC codes, lowercase bases and
    reads shorter than ref_k, and (for even ref_k) palindromic windows,
    whose two forms are equal."""
    seq = _read_chunk(rng, n_pos + ref_k - 1, ref_k)
    iupac = rng.random(seq.shape[0]) < 0.002
    seq[iupac] = np.frombuffer(b"RYSWKMBDHV", dtype=np.uint8)[rng.integers(0, 10, iupac.sum())]
    if ref_k % 2 == 0:
        half = rng.integers(0, 4, ref_k // 2)
        pal = np.frombuffer(b"ACGT", dtype=np.uint8)[np.concatenate([half, 3 - half[::-1]])]
        for at in range(7, n_pos - ref_k, 613):
            seq[at : at + ref_k] = pal
    return seq


@pytest.mark.parametrize("ref_k", [15, 31, 32, 33, 43, 63, 64, 65, 96])
def test_rolling_step_cxx_matches_plain_on_ragged_chunks(rolling_cxx, ref_k):
    """The g++-built rolling step == plain K3 over seeded ragged read
    chunks, with n_pos not a multiple of the kernel's 8192-window tile, in
    runs of 32 windows (one thread of the kernel), of 7 and of the whole
    chunk."""
    rng = np.random.default_rng(100 + ref_k)
    n_pos = 2 * 8192 + 1000 + ref_k
    seq = _ragged_chunk(rng, n_pos, ref_k)
    if ref_k % 2 == 0:  # a palindromic window is its own reverse complement
        win = seq[7 : 7 + ref_k]
        assert revcomp(win[None, :])[0].tobytes() == win.tobytes()
    _check_rolling(rolling_cxx, seq, n_pos, ref_k, (32, 7, n_pos))


# -- whole counter: the three read fixtures of tests/test_counter.py:125-182,
# with alphabets weighted to ACGT so that long windows are valid often enough


def _n_reads(path):
    rng = np.random.default_rng(21)
    base = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=800).tobytes()
    with open(path, "wb") as f:
        for i in range(60):
            s = int(rng.integers(0, 700))
            read = bytearray(base[s : s + 90])
            if rng.random() < 0.2:
                read[rng.integers(0, len(read))] = ord("N")
            f.write(b">r%d\n%s\n" % (i, bytes(read)))


def _lower_short_reads(path):
    rng = np.random.default_rng(9)
    alpha = np.frombuffer(b"ACGTacgt" * 5 + b"Nn", dtype=np.uint8)
    with open(path, "wb") as f:
        for i in range(120):
            length = int(rng.integers(5, 200))
            f.write(b">r%d\n%s\n" % (i, bytes(alpha[rng.integers(0, 42, size=length)])))


def _acgtn_reads(path, ref_k):
    rng = np.random.default_rng(ref_k)
    alpha = np.frombuffer(b"ACGT" * 10 + b"N", dtype=np.uint8)
    with open(path, "wb") as f:
        for i in range(60):
            f.write(b">r%d\n" % i + alpha[rng.integers(0, 41, size=90)].tobytes() + b"\n")


CASES = ([("n_reads", 43, 2, 512), ("lower_short", 43, 1, 256), ("lower_short", 16, 1, 256)]
         + [("acgtn", k, 1, 1 << 10) for k in REF_KS])


def _write_case(tmp_path, name, ref_k):
    path = tmp_path / "reads.fa"
    if name == "n_reads":
        _n_reads(path)
    elif name == "lower_short":
        _lower_short_reads(path)
    else:
        _acgtn_reads(path, ref_k)
    return str(path)


@pytest.mark.parametrize("name,ref_k,ci,chunk", CASES)
def test_count_reads_kmers_matches_jax_and_host(tmp_path, name, ref_k, ci, chunk):
    path = _write_case(tmp_path, name, ref_k)
    kw = dict(ci=ci, log=QUIET, return_packed=True, chunk_kmers=chunk)
    host_k, host_c = mc.count_reads_kmers(path, ref_k, **kw)
    jax_k, jax_c = mc.count_reads_kmers(path, ref_k, use_device=True, **kw)
    got_k, got_c = tc.count_reads_kmers(path, ref_k, device="cpu", **kw)
    assert host_k.shape[0] > 0
    for want_k, want_c in ((host_k, host_c), (jax_k, jax_c)):
        np.testing.assert_array_equal(got_k, want_k)
        np.testing.assert_array_equal(got_c, want_c)
    # ASCII rows, and the host path when no device is given
    ascii_k, _ = tc.count_reads_kmers(path, ref_k, ci=ci, log=QUIET, chunk_kmers=chunk,
                                      device="cpu")
    np.testing.assert_array_equal(ascii_k, mc.count_reads_kmers(path, ref_k, ci=ci,
                                                                log=QUIET)[0])
    np.testing.assert_array_equal(tc.count_reads_kmers(path, ref_k, **kw)[0], host_k)


@pytest.mark.parametrize("chunk", [64, 500, 1 << 12])
def test_device_runs_are_cut_at_exactly_chunk_windows(chunk):
    """The joined reads (0xFF after each read of >= ref_k bases) go to the
    step in ceil(positions / chunk) pieces: no short piece before the end,
    and the union of the pieces is the host sort-count."""
    ref_k = 16
    rng = np.random.default_rng(chunk)
    alpha = np.frombuffer(b"ACGTACGTacgtN", dtype=np.uint8)
    reads = [alpha[rng.integers(0, alpha.shape[0], int(rng.integers(5, 120)))].tobytes()
             for _ in range(300)]
    batches = [reads[i : i + 70] for i in range(0, len(reads), 70)]
    n_pos = sum(len(r) + 1 for r in reads if len(r) >= ref_k) - ref_k + 1
    runs = [r for r in tc.iter_device_runs(batches, ref_k, chunk, "cpu") if r is not None]
    assert len(runs) == -(-n_pos // chunk)
    acc_k, acc_c = np.zeros((0, 1), np.uint64), np.zeros(0, np.int64)
    for keys, cnts in runs:
        acc_k, acc_c = mc._merge_runs(acc_k, acc_c, keys, cnts)
    want_k, want_c = mc._sorted_counts(pack_2bit(canonical(np.concatenate(
        [mc._windows_of_read(r, ref_k) for r in reads]))))
    np.testing.assert_array_equal(acc_k, want_k)
    np.testing.assert_array_equal(acc_c, want_c)


def _spill_runs(batches):
    runs = list(batches)
    return np.concatenate([k for k, _ in runs]), np.concatenate([c for _, c in runs])


@pytest.mark.parametrize("name,ref_k,ci,chunk", CASES)
def test_spill_counter_matches_jax_and_host(tmp_path, name, ref_k, ci, chunk):
    """Bucket by bucket, in the same order."""
    path = _write_case(tmp_path, name, ref_k)
    kw = dict(ci=ci, log=QUIET, chunk_kmers=chunk, n_buckets=8)
    host = _spill_runs(ms.count_reads_kmers_spill(path, ref_k, str(tmp_path / "h"), **kw))
    jax = _spill_runs(ms.count_reads_kmers_spill(path, ref_k, str(tmp_path / "j"),
                                                 use_device=True, **kw))
    got = _spill_runs(ts.count_reads_kmers_spill(path, ref_k, str(tmp_path / "p"),
                                                 device="cpu", **kw))
    assert host[0].shape[0] > 0
    for want in (host, jax):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert not [f for f in os.listdir(tmp_path / "p") if f.startswith("seg")]


def test_spill_counter_resumes_from_a_finished_manifest(tmp_path):
    """A spill left done by an earlier count (kept) is merged, not recounted."""
    path = _write_case(tmp_path, "n_reads", 43)
    kw = dict(log=QUIET, chunk_kmers=512, n_buckets=8, device="cpu")
    first = _spill_runs(ts.count_reads_kmers_spill(path, 43, str(tmp_path / "s"),
                                                   keep_spill=True, **kw))
    log = tmp_path / "log.txt"
    with open(log, "w") as f:
        kw["log"] = f
        again = _spill_runs(ts.count_reads_kmers_spill(path, 43, str(tmp_path / "s"), **kw))
    assert "spill complete: skipping production" in log.read_text()
    np.testing.assert_array_equal(again[0], first[0])
    np.testing.assert_array_equal(again[1], first[1])


@pytest.mark.cuda
def test_seq_pack_on_card_matches_plain(cuda_device):
    """K3 on the card == its plain version, keys and flags, tolerance zero."""
    rng = np.random.default_rng(5)
    for ref_k in REF_KS:
        seq = torch.from_numpy(_read_chunk(rng, (1 << 16) + ref_k - 1, ref_k)).to(cuda_device)
        n_pos = 1 << 16
        keys, valid = kernels.seq_pack(seq, n_pos, ref_k)
        pk, pv = kernels.seq_pack_plain(seq, n_pos, ref_k)
        assert torch.equal(valid, pv) and torch.equal(keys, pk)
