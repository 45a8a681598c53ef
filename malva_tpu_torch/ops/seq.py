"""Sequence byte ops: RCN complement, canonical k-mers, 2-bit packing.

The host half is the port's copy of ``malva_tpu/ops/seq.py`` (numpy over
``(N, K) uint8`` batches, with the native library where it loads).  The
tensor half is the counterpart of ``malva_tpu.ops.seq.complement_jax`` /
``canonical_jax`` (here :func:`canonical_tensor`) and
``malva_tpu.ops.bloom_jax.pack2bit_jax``.

The semantics are the reference's canonicalization (reference:
bloom_filter.hpp:36-65, kmap.hpp:84-97), exactly:

* complement via the RCN table — only A/C/G/N/T (and a handful of
  lowercase entries, including the upstream quirk ``'g' -> 'G'``) are
  mapped; every other byte complements to NUL (0).  IUPAC ambiguity codes
  in real references (R, Y, S, W, ...) therefore turn into 0-bytes in the
  reverse complement, which is observable through hashing and map keys.
* canonical(kmer) = kmer if ``strcmp(kmer, revcomp(kmer)) < 0`` else
  revcomp(kmer).  Since the forward k-mer never contains NULs, strcmp over
  the terminated strings is equivalent to bytewise lexicographic
  comparison over the k bytes (first difference decides; the forward
  k-mer's byte at a position where the revcomp has NUL is always larger).

A table lookup is cheap on a GPU, so on tensors it replaces the TPU's
compare chain.
"""

from __future__ import annotations

import numpy as np
import torch

# RCN complement table, extended to 256 entries (reference accesses only
# 0..127; bytes >= 128 would index negatively through a signed char in the
# reference — UB we define as 0 here).  bloom_filter.hpp:36-50.
RCN_TABLE = np.zeros(256, dtype=np.uint8)
for _src, _dst in [
    ("A", "T"), ("C", "G"), ("G", "C"), ("N", "N"), ("T", "A"),
    ("a", "T"), ("c", "G"), ("g", "G"),  # 'g'->'G' is an upstream quirk, kept
    ("n", "N"), ("t", "A"),
]:
    RCN_TABLE[ord(_src)] = ord(_dst)

_UPPER = np.arange(256, dtype=np.uint8)
_UPPER[ord("a") : ord("z") + 1] = np.arange(ord("A"), ord("Z") + 1, dtype=np.uint8)

# 2-bit encoding for pure-ACGT k-mers: A=0, C=1, G=2, T=3 (preserves ASCII
# order, so integer comparison of packed k-mers == lexicographic ASCII
# comparison — the property the canonical rule depends on).
CODE_TABLE = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate("ACGT"):
    CODE_TABLE[ord(_b)] = _i
DECODE_TABLE = np.frombuffer(b"ACGT", dtype=np.uint8)


def upper(a: np.ndarray) -> np.ndarray:
    """ASCII-uppercase a uint8 array (mirrors ::toupper over A-Za-z)."""
    return _UPPER[a]


def revcomp(kmers: np.ndarray) -> np.ndarray:
    """Reverse complement of each row of an (N, K) uint8 batch."""
    return RCN_TABLE[kmers][:, ::-1]


def _lex_less(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rowwise lexicographic a < b for (N, K) uint8 arrays."""
    n, k = a.shape
    less = np.zeros(n, dtype=bool)
    decided = np.zeros(n, dtype=bool)
    for j in range(k):
        aj = a[:, j]
        bj = b[:, j]
        less |= ~decided & (aj < bj)
        decided |= aj != bj
    return less


def canonical(kmers: np.ndarray) -> np.ndarray:
    """Canonical form of each row: min(kmer, revcomp(kmer)) per strcmp.

    Matches BF::_canonical (bloom_filter.hpp:58-65): the reverse complement
    wins ties (strcmp == 0 keeps the computed revcomp, which then equals
    the forward k-mer bytewise anyway).  :func:`canonical_tensor` is the
    same on a torch tensor.
    """
    kmers = np.asarray(kmers, dtype=np.uint8)
    if kmers.ndim == 2 and kmers.size:
        from ..utils import native

        out = native.canonical(kmers)
        if out is not None:
            return out
    rc = revcomp(kmers)
    keep_fwd = _lex_less(kmers, rc)
    return np.where(keep_fwd[:, None], kmers, rc)


def truncate_at_nul(keys: np.ndarray) -> np.ndarray:
    """Zero every byte at/after the first NUL in each row.

    KMAP keys are built with ``std::string kmer_string(ckmer)`` from a
    C-string (kmap.hpp:95), so a canonical form containing NUL (from a
    non-ACGTN byte) is truncated.  The padded-with-zeros fixed-width
    representation of the truncated string is unique, so zero-filling the
    tail is an exact model of the reference's key.
    """
    keys = np.asarray(keys, dtype=np.uint8)
    if keys.ndim == 2 and keys.size:
        from ..utils import native

        out = native.truncate_nul(keys)
        if out is not None:
            return out
    nul = keys == 0
    seen = np.cumsum(nul, axis=1) > 0
    out = keys.copy()
    out[seen] = 0
    return out


def pack_2bit(kmers: np.ndarray) -> np.ndarray:
    """Pack pure-ACGT (N, K) uint8 ASCII rows into (N, ceil(K/32)) uint64.

    Base j of a row lands in word j//32 at bit position 2*(31 - j%32), i.e.
    most-significant-first within each word and words ordered left to
    right, so that comparing the uint64 tuple (word0, word1, ...) orders
    rows exactly like ASCII lexicographic comparison of the k-mers.
    Rows containing non-ACGT bytes are the caller's responsibility (use
    :func:`is_acgt`).
    """
    kmers = np.asarray(kmers, dtype=np.uint8)
    n, k = kmers.shape
    if kmers.size:
        from ..utils import native

        out = native.pack2bit(kmers)
        if out is not None:
            return out
    codes = CODE_TABLE[kmers].astype(np.uint64)
    nwords = (k + 31) // 32
    out = np.zeros((n, nwords), dtype=np.uint64)
    for j in range(k):
        w = j // 32
        shift = np.uint64(2 * (31 - (j % 32)))
        out[:, w] |= codes[:, j] << shift
    return out


def unpack_2bit(packed: np.ndarray, k: int) -> np.ndarray:
    """Inverse of :func:`pack_2bit` back to (N, K) ASCII uint8."""
    packed = np.asarray(packed, dtype=np.uint64)
    n = packed.shape[0]
    if packed.size:
        from ..utils import native

        out = native.unpack2bit(packed, k)
        if out is not None:
            return out
    out = np.empty((n, k), dtype=np.uint8)
    for j in range(k):
        w = j // 32
        shift = np.uint64(2 * (31 - (j % 32)))
        out[:, j] = DECODE_TABLE[((packed[:, w] >> shift) & np.uint64(3)).astype(np.intp)]
    return out


def is_acgt(kmers: np.ndarray) -> np.ndarray:
    """Rowwise mask: True where every byte is one of A/C/G/T."""
    return (CODE_TABLE[kmers] != 255).all(axis=1)


# ---------------------------------------------------------------------------
# torch tensors (device path)
# ---------------------------------------------------------------------------


def complement(kmers: torch.Tensor) -> torch.Tensor:
    """RCN complement of a uint8 tensor of any shape."""
    table = torch.from_numpy(RCN_TABLE).to(kmers.device)
    return table[kmers.to(torch.int64)]


def canonical_decision(fwd_cols, rc_cols) -> torch.Tensor:
    """Per lane: True where the forward form is strictly less than the
    reverse complement (strcmp order; ties keep the reverse complement,
    seq.canonical).  Both arguments are lists of equal-shape columns."""
    less = torch.zeros(fwd_cols[0].shape, dtype=torch.bool, device=fwd_cols[0].device)
    decided = torch.zeros_like(less)
    for a, b in zip(fwd_cols, rc_cols):
        less |= ~decided & (a < b)
        decided |= a != b
    return less


def canonical_tensor(kmers: torch.Tensor) -> torch.Tensor:
    """Canonical form of each row of an (N, K) uint8 tensor."""
    rc = complement(kmers).flip(1)
    k = kmers.shape[1]
    keep = canonical_decision([kmers[:, j] for j in range(k)], [rc[:, j] for j in range(k)])
    return torch.where(keep[:, None], kmers, rc)


def pack2bit(kmers: torch.Tensor, k: int) -> torch.Tensor:
    """Pack pure-ACGT (N, k) ASCII rows into (N, ceil(k/16)) int64 lanes
    holding uint32 words: 16 bases a word, base 0 in the top bits, so
    word-tuple order is ASCII order.  Non-ACGT bytes give arbitrary codes
    (callers pack pure-ACGT rows only), as ``pack2bit_jax``."""
    c2 = (kmers.to(torch.int64) >> 1) & 3
    codes = c2 ^ (c2 >> 1)
    cols = []
    for w in range((k + 15) // 16):
        acc = torch.zeros(kmers.shape[0], dtype=torch.int64, device=kmers.device)
        for j in range(w * 16, min((w + 1) * 16, k)):
            acc |= codes[:, j] << (2 * (15 - (j - w * 16)))
        cols.append(acc)
    return torch.stack(cols, dim=1)
