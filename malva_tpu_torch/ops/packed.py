"""Sequence ops on torch tensors: the RCN complement, the canonical
decision, and the 2-bit packed-word helpers of the call-step front end.

:func:`complement`, :func:`canonical_tensor` and :func:`pack2bit` are
the counterparts of ``malva_tpu.ops.seq.complement_jax`` /
``canonical_jax`` and ``malva_tpu.ops.bloom_jax.pack2bit_jax``, with the
semantics of ``ops/seq.py`` (the host half, numpy only); a table lookup
is cheap on a GPU, so it replaces the TPU's compare chain.  The packed
helpers are the counterparts of ``malva_tpu/ops/pallas_kernels.py:40-121``.
A packed sequence is a list of int64 lane tensors, each holding one
uint32 word: 16 bases a word, base 0 in the top 2 bits (A=0 < C=1 < G=2
< T=3, so word-tuple comparison is ASCII strcmp).
"""

from __future__ import annotations

import torch

from .seq import RCN_TABLE

M32 = 0xFFFFFFFF


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


def decode_byte_cols(words, n_bases: int):
    """ASCII byte columns (A/C/G/T -> 65/67/71/84) of a packed sequence."""
    cols = []
    for j in range(n_bases):
        c = (words[j // 16] >> (2 * (15 - j % 16))) & 3
        cols.append(65 + (c << 1) + (c == 2).to(torch.int64) * 2 + (c == 3).to(torch.int64) * 13)
    return cols


def rev2bit(x):
    """Reverse the 16 2-bit groups of each uint32 lane."""
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & M32


def _top_mask(n_bases: int) -> int:
    return (((1 << (2 * n_bases)) - 1) << (32 - 2 * n_bases)) & M32


def extract_subpacked(words, off: int, k: int):
    """Packed words of the length-k subsequence starting at base ``off``."""
    w_k = (k + 15) // 16
    s = 2 * (off % 16)
    a0 = off // 16
    out = []
    for i in range(w_k):
        v = words[a0 + i]
        if s:
            v = (v << s) & M32
            if a0 + i + 1 < len(words):
                v = v | (words[a0 + i + 1] >> (32 - s))
        out.append(v)
    tail = k - 16 * (w_k - 1)
    if tail < 16:
        out[-1] = out[-1] & _top_mask(tail)
    return out


def revcomp_packed(words, k: int):
    """Reverse complement of a k-base packed sequence (pure ACGT:
    complement code = code ^ 3)."""
    w_k = len(words)
    comp = [w ^ _top_mask(min(16, k - 16 * i)) for i, w in enumerate(words)]
    v = [rev2bit(comp[w_k - 1 - i]) for i in range(w_k)]
    t = 2 * (16 * w_k - k)  # garbage-base lead to shift out
    if t == 0:
        return v
    out = []
    for i in range(w_k):
        x = (v[i] << t) & M32
        if i + 1 < w_k:
            x = x | (v[i + 1] >> (32 - t))
        out.append(x)
    return out


def lex_min_packed(a, b):
    """Per-lane lexicographic min of two packed-word tuples; ties keep b
    (equal either way), matching seq.canonical's strcmp rule."""
    less = canonical_decision(a, b)
    return [torch.where(less, x, y) for x, y in zip(a, b)]


def canonical_center(words, k: int, ref_k: int):
    """Packed canonical form of the centered k-mer of packed contexts."""
    cen = extract_subpacked(words, (ref_k - k) // 2, k)
    return lex_min_packed(cen, revcomp_packed(cen, k))


def popcount32(x):
    """SWAR popcount of uint32 lanes held in int64 (torch has no popcount)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24
