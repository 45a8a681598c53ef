"""Sequence byte ops on tensors: RCN complement, canonical k-mers, 2-bit pack.

Counterparts of ``malva_tpu.ops.seq.complement_jax`` / ``canonical_jax``
and ``malva_tpu.ops.bloom_jax.pack2bit_jax``.  The complement is the
reference's RCN table: A/C/G/N/T plus lowercase a/c/g/n/t (with the
upstream ``g -> G`` quirk); every other byte complements to NUL.  A
table lookup is cheap on a GPU, so it replaces the TPU's compare chain.
"""

from __future__ import annotations

import torch

from malva_tpu.ops.seq import RCN_TABLE


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


def canonical(kmers: torch.Tensor) -> torch.Tensor:
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
