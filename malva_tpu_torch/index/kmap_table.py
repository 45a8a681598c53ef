"""Exact-map probe on tensors: two-choice, 4-slot bucket table.

Counterparts of ``malva_tpu/index/kmap_table.py:149 bucket_pair_jax`` and
``:158 probe_bucket_table``.  The table itself is the host
``malva_tpu.index.kmap_table.BucketTable``, used unchanged; its
``bucket_keys`` ((n_buckets, SLOTS * w) uint32) are uploaded as int32
storage (ops.bloom).
"""

from __future__ import annotations

import torch

from malva_tpu.index.kmap_table import SLOTS

from ..ops.bloom import lanes

M32 = 0xFFFFFFFF


def bucket_pair(hash_hi, hash_lo, n_buckets: int):
    """(b1, b2) = (lo ^ hi, lo * 0x9E3779B1 ^ hi * 0x85EBCA77), masked
    to the bucket count.  int64 lanes in, int64 bucket indices out."""
    mask = n_buckets - 1
    b1 = (hash_lo ^ hash_hi) & mask
    b2 = (((hash_lo * 0x9E3779B1) & M32) ^ ((hash_hi * 0x85EBCA77) & M32)) & mask
    return b1, b2


def probe_bucket_table(bucket_keys: torch.Tensor, n_buckets: int, w: int, packed,
                       hash_hi, hash_lo):
    """-> (flat slot index, found) per lane; ``packed`` is the list of
    the lanes' w packed key words.  Both buckets x 4 slots are compared,
    and the first match (bucket 1 before bucket 2, low slot first) wins."""
    found = torch.zeros(packed[0].shape, dtype=torch.bool, device=packed[0].device)
    slot = torch.zeros(packed[0].shape, dtype=torch.int64, device=packed[0].device)
    for b in bucket_pair(hash_hi, hash_lo, n_buckets):
        rows = lanes(bucket_keys[b])  # (B, SLOTS * w)
        for s in range(SLOTS):
            eq = torch.ones_like(found)
            for j in range(w):
                eq &= rows[:, s * w + j] == packed[j]
            slot = torch.where(eq & ~found, b * SLOTS + s, slot)
            found |= eq
    return slot, found
