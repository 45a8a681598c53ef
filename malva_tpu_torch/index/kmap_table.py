"""Device exact-map layout: two-choice bucketized cuckoo hash table.

The port's copy of ``malva_tpu/index/kmap_table.py``.  The exact
reference-allele map is laid out as buckets of 4 candidate keys; a query
reads its (at most two) candidate bucket rows and compares all slots.
Both bucket indices are derived from the XXH3 hash of the canonical k-mer
that the call step already computes for the Bloom probe (b1 = lo ^ hi,
b2 = lo*C1 ^ hi*C2, masked), so no extra hashing happens on the device.

Two choices + 4 slots (bucketized cuckoo) keep the table at a fixed load
factor <= 0.5 (n_buckets*SLOTS >= 2*keys): a single-choice 4-slot table
overflows with near-certainty for millions of keys.  The build
(:class:`BucketTable`) is a vectorized two-pass placement on the host
plus a tiny cuckoo eviction loop for the stragglers; its ``bucket_keys``
((n_buckets, SLOTS * w) uint32) are uploaded as int32 storage
(ops.bloom).  :func:`bucket_pair` and :func:`probe_bucket_table` are the
tensor counterparts of ``bucket_pair_jax`` (``:149``) and
``probe_bucket_table`` (``:158``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bloom import lanes
from ..ops.xxh3 import xxh3_64

SLOTS = 4
# bucket-2 mixers (odd constants; independent of the b1 = lo^hi mix)
BMIX1 = np.uint32(0x9E3779B1)
BMIX2 = np.uint32(0x85EBCA77)
_MAX_EVICT = 500


def bucket_pair_np(lo: np.ndarray, hi: np.ndarray, n_buckets: int):
    mask = np.uint32(n_buckets - 1)
    b1 = (lo ^ hi) & mask
    b2 = ((lo * BMIX1) ^ (hi * BMIX2)) & mask
    return b1, b2


class BucketTable:
    def __init__(self, keys: list[bytes], k: int, min_buckets: int = 1,
                 rows: np.ndarray | None = None):
        """``rows``, where given, are the keys as (N, k) uint8 rows."""
        self.k = k
        self.w = (k + 15) // 16
        if keys:
            arr = (np.frombuffer(b"".join(keys), dtype=np.uint8).reshape(-1, self.k)
                   if rows is None else rows)
            from .device import pack2bit_u32_np

            packed = pack2bit_u32_np(arr, self.k)
            h = xxh3_64(arr)
        else:
            packed = np.zeros((0, self.w), dtype=np.uint32)
            h = np.zeros(0, dtype=np.uint64)
        self._build(packed, h, keys, min_buckets)

    @classmethod
    def from_packed(cls, packed: np.ndarray, h: np.ndarray, k: int,
                    min_buckets: int = 1) -> "BucketTable":
        """Build straight from packed keys + hashes (no byte-key list;
        set_vals_from/write_back are unavailable — bench/bulk use)."""
        self = cls.__new__(cls)
        self.k = k
        self.w = (k + 15) // 16
        self._build(packed, h, None, min_buckets)
        return self

    def _build(self, packed, h, keys, min_buckets: int) -> None:
        self.key_hashes = h  # XXH3 of each key, in input order (the mini-filter's input)
        m = packed.shape[0]
        n_buckets = max(1, min_buckets)
        while n_buckets * SLOTS < 2 * m:  # load factor <= 0.5
            n_buckets <<= 1
        lo = (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (h >> np.uint64(32)).astype(np.uint32)
        while not self._try_build(packed, lo, hi, keys, n_buckets):
            n_buckets <<= 1

    def _try_build(self, packed, lo, hi, keys, n_buckets: int) -> bool:
        w = self.w
        m = packed.shape[0]
        b1, b2 = bucket_pair_np(lo, hi, n_buckets)
        b1 = b1.astype(np.int64)
        b2 = b2.astype(np.int64)
        fill = np.zeros(n_buckets, dtype=np.int32)
        slot_of = np.full((n_buckets, SLOTS), -1, dtype=np.int64)  # key index

        def place_pass(bsel, idx):
            """Place keys ``idx`` into buckets ``bsel`` (vectorized, honors
            current fill); returns the indices that did not fit."""
            if idx.size == 0:
                return idx
            order = np.argsort(bsel, kind="stable")
            sb = bsel[order]
            new_run = np.concatenate([[True], sb[1:] != sb[:-1]])
            run_start = np.maximum.accumulate(
                np.where(new_run, np.arange(sb.size), 0)
            )
            slot = (np.arange(sb.size) - run_start) + fill[sb]
            ok = slot < SLOTS
            ki = idx[order]
            slot_of[sb[ok], slot[ok]] = ki[ok]
            np.add.at(fill, sb[ok], 1)
            return ki[~ok]

        left = place_pass(b1, np.arange(m, dtype=np.int64))
        left = place_pass(b2[left], left)

        # cuckoo eviction for the stragglers (rare: load <= 0.5)
        for i in left.tolist():
            cur, b = i, int(b1[i])
            for step in range(_MAX_EVICT):
                f = fill[b]
                if f < SLOTS:
                    slot_of[b, f] = cur
                    fill[b] = f + 1
                    break
                victim = int(slot_of[b, step % SLOTS])
                slot_of[b, step % SLOTS] = cur
                cur = victim
                b = int(b1[cur]) if b == int(b2[cur]) else int(b2[cur])
            else:
                return False

        bucket_keys = np.full((n_buckets, SLOTS, w), 0xFFFFFFFF, dtype=np.uint32)
        occ_b, occ_s = np.nonzero(slot_of >= 0)
        ki = slot_of[occ_b, occ_s]
        bucket_keys[occ_b, occ_s] = packed[ki]
        self.n_buckets = n_buckets
        self.bucket_keys = bucket_keys.reshape(n_buckets, SLOTS * w)
        self.vals = np.zeros(n_buckets * SLOTS, dtype=np.uint32)
        if keys is None:
            self.slot_keys = None
        else:
            # the occupied slots and their keys, in slot order
            flat = occ_b * SLOTS + occ_s
            slot_keys = np.full(n_buckets * SLOTS, None, dtype=object)
            slot_keys[flat] = np.array(keys, dtype=object)[ki]
            self.slot_keys = slot_keys.tolist()
            self._occupied = flat
            self._occupied_index = ki
            self._occupied_keys = slot_keys[flat].tolist()
        return True

    def set_vals(self, vals: np.ndarray) -> None:
        """The values of the keys, ``vals[i]`` that of the table's key i."""
        self.vals[self._occupied] = vals[self._occupied_index]

    def set_vals_from(self, kmers: dict) -> None:
        self.vals[self._occupied] = np.fromiter(
            map(kmers.__getitem__, self._occupied_keys), np.uint32, len(self._occupied_keys))

    def write_back(self, vals: np.ndarray, kmers: dict) -> None:
        kmers.update(zip(self._occupied_keys, vals[self._occupied].tolist()))


M32 = 0xFFFFFFFF


def bucket_pair(hash_hi, hash_lo, n_buckets: int):
    """(b1, b2) = (lo ^ hi, lo * 0x9E3779B1 ^ hi * 0x85EBCA77), masked
    to the bucket count.  int64 lanes in, int64 bucket indices out."""
    mask = n_buckets - 1
    b1 = (hash_lo ^ hash_hi) & mask
    b2 = (((hash_lo * 0x9E3779B1) & M32) ^ ((hash_hi * 0x85EBCA77) & M32)) & mask
    return b1, b2


def probe_bucket_table(bucket_keys: torch.Tensor, n_buckets: int, w: int, packed,
                       hash_hi, hash_lo, base: int = 0):
    """-> (flat slot index, found) per lane; ``packed`` is the list of
    the lanes' w packed key words.  Both buckets x 4 slots are compared,
    and the first match (bucket 1 before bucket 2, low slot first) wins.
    ``bucket_keys`` may hold only buckets ``base ..`` of a table of
    ``n_buckets`` (one shard's contiguous range,
    malva_tpu/parallel/sharded_index.py:169-183): a bucket outside it never
    matches, and the slot is relative to ``base``."""
    found = torch.zeros(packed[0].shape, dtype=torch.bool, device=packed[0].device)
    slot = torch.zeros(packed[0].shape, dtype=torch.int64, device=packed[0].device)
    for b in bucket_pair(hash_hi, hash_lo, n_buckets):
        lb = b - base
        mine = (lb >= 0) & (lb < bucket_keys.shape[0])
        lb = torch.where(mine, lb, 0)
        rows = lanes(bucket_keys[lb])  # (B, SLOTS * w)
        for s in range(SLOTS):
            eq = mine.clone()
            for j in range(w):
                eq &= rows[:, s * w + j] == packed[j]
            slot = torch.where(eq & ~found, lb * SLOTS + s, slot)
            found |= eq
    return slot, found
