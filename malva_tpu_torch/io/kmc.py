"""KMC database (.kmc_pre / .kmc_suf) reader and writer.

The reference consumes a KMC database through the KMC API
(reference: main.cpp:445 `OpenForListing`, :484 `Info`, :488
`ReadNextKmer`); a user migrating from MALVA has these files on disk.
This module reads the on-disk format directly (no libkmc):

.kmc_pre layout::

    [marker "KMCP" 4B]
    [prefix LUT: uint64 little-endian array]
    [signature map: uint32 array, (4^signature_len + 1) entries]   (v2 only)
    [header]
    [header_offset: uint32]  — byte length of the header block
    [marker "KMCP" 4B]

The header's trailing uint32 (at file_size-12) is the KMC version tag:
0 for KMC1, 0x200 for KMC2/3.  Header fields, in order (all uint32
little-endian unless noted): kmer_length, mode, counter_size,
lut_prefix_length, signature_len (v2 only), min_count, max_count,
total_kmers (uint64), both_strands (uchar + 3 pad).

.kmc_suf layout::

    [marker "KMCS" 4B]
    [records: total_kmers x (suffix_bytes + counter_size)]
    [marker "KMCS" 4B]

Records are sorted by k-mer.  A record's k-mer = its LUT prefix (the
index p such that lut[p] <= record_index < lut[p+1], spanning
2*lut_prefix_length bits) concatenated with suffix_bytes =
(kmer_length - lut_prefix_length)/4 bytes, 4 bases per byte, first base
in the top 2 bits; counters are little-endian (mode 0).  K-mers are
canonical (both_strands) under the 2-bit A<C<G<T order — the same order
as ASCII strcmp, i.e. exactly our canonical form.

The writer emits a well-formed v2 (0x200) database (trivial signature
map) — used for round-trip gates and to export our counter's output for
any KMC-API consumer.  No real KMC binary exists in this environment to
cross-validate against; the layout above is implemented from the
published format and every structural assumption is exercised by the
round-trip + pipeline byte-equality tests (tests/test_kmc.py).
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..utils.errors import InputError

_PRE_MARKER = b"KMCP"
_SUF_MARKER = b"KMCS"
KMC2_VERSION = 0x200


def _counts_from_lut(lut: np.ndarray, n: int) -> np.ndarray:
    """Per-prefix record counts from the cumulative LUT."""
    lut = np.minimum(lut, n)
    return np.diff(lut).astype(np.int64)


def read_kmc_pre(prefix_path: str):
    """Parse the .kmc_pre file: returns (lut uint64 array, info dict).
    Accepts KMC1 (version 0) and KMC2/3 (0x200)."""
    pre = prefix_path + ".kmc_pre"
    with open(pre, "rb") as f:
        data = f.read()
    if data[:4] != _PRE_MARKER or data[-4:] != _PRE_MARKER:
        raise InputError(f"{pre}: bad KMCP markers")
    header_offset = struct.unpack_from("<I", data, len(data) - 8)[0]
    version = struct.unpack_from("<I", data, len(data) - 12)[0]
    hdr_start = len(data) - 8 - header_offset
    off = hdr_start
    (kmer_length, mode, counter_size, lut_prefix_length) = struct.unpack_from(
        "<4I", data, off
    )
    off += 16
    signature_len = 0
    if version == KMC2_VERSION:
        signature_len = struct.unpack_from("<I", data, off)[0]
        off += 4
    min_count, max_count = struct.unpack_from("<2I", data, off)
    off += 8
    total_kmers = struct.unpack_from("<Q", data, off)[0]
    off += 8
    both_strands = data[off] == 0  # stored inverted ("one strand only")
    if mode != 0:
        raise InputError("quality-mode (Quake) KMC databases are unsupported")
    if counter_size not in (1, 2, 3, 4):
        raise InputError(f"unsupported counter_size {counter_size}")

    lut_end = hdr_start
    if version == KMC2_VERSION:
        lut_end -= ((1 << (2 * signature_len)) + 1) * 4  # signature map
    lut = np.frombuffer(data, dtype="<u8", offset=4, count=(lut_end - 4) // 8)

    info = dict(
        kmer_length=kmer_length, mode=mode, counter_size=counter_size,
        lut_prefix_length=lut_prefix_length, signature_len=signature_len,
        min_count=min_count, max_count=max_count, total_kmers=total_kmers,
        both_strands=both_strands, version=version,
    )
    return lut, info


def _decode_records(body: np.ndarray, prefix_of: np.ndarray, info: dict
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(records (M, rec) uint8, LUT prefix values (M,)) -> (kmers ASCII
    (M, k) uint8, counts (M,) uint32)."""
    kmer_length = info["kmer_length"]
    lut_prefix_length = info["lut_prefix_length"]
    counter_size = info["counter_size"]
    suffix_bytes = (kmer_length - lut_prefix_length) // 4
    m = body.shape[0]

    counts = np.zeros(m, dtype=np.uint32)
    for b in range(counter_size):
        counts |= body[:, suffix_bytes + b].astype(np.uint32) << np.uint32(8 * b)

    decode = np.frombuffer(b"ACGT", dtype=np.uint8)
    out = np.empty((m, kmer_length), dtype=np.uint8)
    for j in range(lut_prefix_length):
        sh = 2 * (lut_prefix_length - 1 - j)
        out[:, j] = decode[(prefix_of >> sh) & 3]
    for j in range(kmer_length - lut_prefix_length):
        byte = body[:, j // 4]
        sh = 2 * (3 - (j % 4))
        out[:, lut_prefix_length + j] = decode[(byte >> sh) & 3]
    return out, counts


def iter_kmc_db(prefix_path: str, batch_kmers: int = 1 << 22):
    """Stream a KMC database as ((M, k) uint8 ASCII, (M,) uint32) batches —
    a WGS database holds billions of records and must never materialize
    whole.  The LUT prefix of each record is recovered by binary search of
    the record index in the cumulative LUT (identical to the repeat-based
    whole-file decode)."""
    lut, info = read_kmc_pre(prefix_path)
    suf = prefix_path + ".kmc_suf"
    n = int(info["total_kmers"])
    suffix_bytes = (info["kmer_length"] - info["lut_prefix_length"]) // 4
    rec = suffix_bytes + info["counter_size"]
    pref_mask = (1 << (2 * info["lut_prefix_length"])) - 1
    lut_c = np.minimum(lut.astype(np.int64), n)
    if int(_counts_from_lut(lut, n).sum()) != n:
        raise InputError(
            f"{prefix_path}.kmc_pre: LUT covers "
            f"{int(_counts_from_lut(lut, n).sum())} of {n} records"
        )
    size = os.path.getsize(suf)
    if size != n * rec + 8:
        raise InputError(f"{suf}: {size - 8} record bytes != {n} x {rec}")
    with open(suf, "rb") as f:
        if f.read(4) != _SUF_MARKER:
            raise InputError(f"{suf}: bad KMCS markers")
        at = 0
        while at < n:
            m = min(batch_kmers, n - at)
            raw = f.read(m * rec)
            body = np.frombuffer(raw, dtype=np.uint8).reshape(m, rec)
            idx = np.arange(at, at + m, dtype=np.int64)
            prefix_of = (np.searchsorted(lut_c, idx, side="right") - 1) & pref_mask
            yield _decode_records(body, prefix_of, info)
            at += m
        if f.read(4) != _SUF_MARKER:
            raise InputError(f"{suf}: bad KMCS markers")


def read_kmc_db(prefix_path: str):
    """Whole-file read of a KMC database; returns (kmers_ascii (N, k)
    uint8, counts uint32, info dict).  Use :func:`iter_kmc_db` for
    databases that do not fit RAM."""
    _, info = read_kmc_pre(prefix_path)
    ks, cs = [], []
    for k_arr, c_arr in iter_kmc_db(prefix_path):
        ks.append(k_arr)
        cs.append(c_arr)
    if not ks:
        return (np.zeros((0, info["kmer_length"]), np.uint8),
                np.zeros(0, np.uint32), info)
    return np.concatenate(ks), np.concatenate(cs), info


def write_kmc_db(prefix_path: str, kmers: np.ndarray, counts: np.ndarray,
                 lut_prefix_length: int | None = None,
                 counter_size: int = 4, signature_len: int = 9,
                 min_count: int = 2, max_count: int = 255) -> None:
    """Write a KMC2-format database from (N, k) ASCII uint8 canonical
    k-mers + uint32 counts (need not be pre-sorted)."""
    from ..ops.seq import CODE_TABLE

    n, k = kmers.shape if kmers.size else (0, kmers.shape[1])
    if lut_prefix_length is None:
        # KMC's own heuristic territory; any value with (k - p) % 4 == 0 works
        lut_prefix_length = 1
        while (k - lut_prefix_length) % 4:
            lut_prefix_length += 1
    assert (k - lut_prefix_length) % 4 == 0
    codes = CODE_TABLE[kmers].astype(np.uint64)
    if np.any(codes > 3):
        raise InputError("KMC databases hold pure-ACGT k-mers")

    # sort by k-mer (2-bit order == ASCII order)
    keyw = np.zeros((n, (k + 31) // 32), dtype=np.uint64)
    for j in range(k):
        keyw[:, j // 32] |= codes[:, j] << np.uint64(2 * (31 - (j % 32)))
    order = np.lexsort(tuple(keyw[:, w] for w in range(keyw.shape[1] - 1, -1, -1)))
    codes = codes[order]
    counts = np.asarray(counts, dtype=np.uint32)[order]

    prefix_vals = np.zeros(n, dtype=np.int64)
    for j in range(lut_prefix_length):
        prefix_vals = (prefix_vals << 2) | codes[:, j].astype(np.int64)
    n_pref = 1 << (2 * lut_prefix_length)
    lut = np.zeros(n_pref + 1, dtype="<u8")
    cnt_per = np.zeros(n_pref, dtype=np.int64)
    np.add.at(cnt_per, prefix_vals, 1)
    lut[1:] = np.cumsum(cnt_per)

    suffix_bytes = (k - lut_prefix_length) // 4
    rec = np.zeros((n, suffix_bytes + counter_size), dtype=np.uint8)
    for j in range(k - lut_prefix_length):
        sh = np.uint8(2 * (3 - (j % 4)))
        rec[:, j // 4] |= (codes[:, lut_prefix_length + j].astype(np.uint8) << sh)
    for b in range(counter_size):
        rec[:, suffix_bytes + b] = (counts >> np.uint32(8 * b)).astype(np.uint8)

    sig_map = np.zeros((1 << (2 * signature_len)) + 1, dtype="<u4")
    header = struct.pack(
        "<5I", k, 0, counter_size, lut_prefix_length, signature_len
    ) + struct.pack("<2I", min_count, max_count) + struct.pack("<Q", n)
    header += bytes([0, 0, 0, 0])  # both_strands=0 (stored inverted) + pad
    header += struct.pack("<I", KMC2_VERSION)  # version tag at size-12

    with open(prefix_path + ".kmc_pre.tmp", "wb") as f:
        f.write(_PRE_MARKER)
        f.write(lut.tobytes())
        f.write(sig_map.tobytes())
        f.write(header)
        f.write(struct.pack("<I", len(header)))
        f.write(_PRE_MARKER)
    os.replace(prefix_path + ".kmc_pre.tmp", prefix_path + ".kmc_pre")
    with open(prefix_path + ".kmc_suf.tmp", "wb") as f:
        f.write(_SUF_MARKER)
        f.write(rec.tobytes())
        f.write(_SUF_MARKER)
    os.replace(prefix_path + ".kmc_suf.tmp", prefix_path + ".kmc_suf")


def load_kmc_db(prefix_path: str, ref_k: int):
    """Pipeline entry: (contexts (N, ref_k) uint8 ASCII, counts uint32),
    matching load_kmc_dump's contract (reference main.cpp:482-500)."""
    kmers, counts, info = read_kmc_db(prefix_path)
    if info["kmer_length"] != ref_k:
        raise InputError(
            f"KMC database k={info['kmer_length']} != ref_k {ref_k}"
        )
    return kmers, counts
