"""Single-probe Bloom filter with rank-compressed counters (host mirror).

Observable semantics match the reference BF (reference:
bloom_filter.hpp:52-157): one XXH3_64bits hash of the canonical k-mer,
index = hash % size; counters exist only for set bits, addressed by
rank(index), stored mod 2^16.  The layout here is TPU-native: the bit
array is uint32 words, rank is a per-word exclusive popcount cumsum
(rebuilt at switch_mode/load, like upstream rebuilds rank_support_v), and
counters accumulate in uint32 (mod 2^16 applied at read — equivalent to
per-store wraparound since the wrap is linear).

All APIs are batched over ``(N, K) uint8`` ASCII k-mer arrays; the device
(JAX) mirror of the query/increment path lives in malva_tpu.ops.bloom.
"""

from __future__ import annotations

import numpy as np

from ..ops.seq import canonical
from ..ops.xxh3 import xxh3_64


class BF:
    def __init__(self, size_bits: int = 0):
        self.size = int(size_bits)
        nwords = (self.size + 31) // 32
        self.words = np.zeros(nwords, dtype=np.uint32)
        self.mode = False  # False = write, True = read (counters active)
        self._rank: np.ndarray | None = None  # (nwords,) u32 exclusive cumsum
        self.counts: np.ndarray | None = None  # (popcount,) uint32

    @property
    def rank(self) -> "np.ndarray | None":
        """Per-word exclusive popcount cumsum — built LAZILY on first use:
        the context filter is only ever bit-probed, and a 1 GiB rank
        array costs ~13 s of first-touch page faults on this VM class."""
        if self._rank is None and self.mode:
            from ..utils.native import bf_rank

            out = bf_rank(self.words)
            if out is not None:
                self._rank = out[0]
            else:
                pc = np.bitwise_count(self.words).astype(np.uint32)
                cs = np.cumsum(pc, dtype=np.uint32)
                r = np.empty_like(cs)
                r[0] = 0
                r[1:] = cs[:-1]
                self._rank = r
        return self._rank

    @rank.setter
    def rank(self, v) -> None:
        self._rank = v

    # -- hashing -----------------------------------------------------------
    def _indices(self, kmers: np.ndarray) -> np.ndarray:
        from ..utils import native

        h = native.canonical_xxh3(kmers) if len(kmers) else None
        if h is None:
            h = xxh3_64(canonical(kmers))
        return h % np.uint64(self.size)

    # -- write mode --------------------------------------------------------
    def add_keys(self, kmers: np.ndarray) -> None:
        if len(kmers) == 0:
            return
        idx = self._indices(kmers)
        word = (idx >> np.uint64(5)).astype(np.int64)
        mask = (np.uint32(1) << (idx & np.uint64(31)).astype(np.uint32)).astype(np.uint32)
        from ..utils import native

        if not native.scatter_or_u32(self.words, word, mask):
            np.bitwise_or.at(self.words, word, mask)

    def test_keys(self, kmers: np.ndarray) -> np.ndarray:
        if len(kmers) == 0:
            return np.zeros(0, dtype=bool)
        idx = self._indices(kmers)
        word = (idx >> np.uint64(5)).astype(np.int64)
        bit = (idx & np.uint64(31)).astype(np.uint32)
        return ((self.words[word] >> bit) & np.uint32(1)).astype(bool)

    # -- read mode ---------------------------------------------------------
    def switch_mode(self) -> None:
        self.mode = True
        from ..utils.native import popcount_sum

        total = popcount_sum(self.words)
        if total is None:
            # chunked: a whole-array bitwise_count temp would itself pay
            # the first-touch fault tax this path exists to avoid
            total = 0
            for lo in range(0, self.words.shape[0], 1 << 24):
                total += int(
                    np.bitwise_count(self.words[lo : lo + (1 << 24)])
                    .sum(dtype=np.uint64)
                )
        if total >= 1 << 32:
            raise OverflowError("Bloom filter popcount exceeds uint32 rank range")
        self._rank = None  # built lazily on first counter access
        self.counts = np.zeros(total, dtype=np.uint32)

    def _count_indices(self, kmers: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(is_set mask, counter index) for each k-mer (valid where is_set)."""
        return self._count_from_idx(self._indices(kmers))

    def _count_from_idx(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        word = (idx >> np.uint64(5)).astype(np.int64)
        bit = (idx & np.uint64(31)).astype(np.uint32)
        wvals = self.words[word]
        is_set = ((wvals >> bit) & np.uint32(1)).astype(bool)
        below = wvals & ((np.uint32(1) << bit) - np.uint32(1))
        cnt_idx = self.rank[word] + np.bitwise_count(below).astype(np.uint64)
        return is_set, cnt_idx.astype(np.int64)

    # -- precomputed-hash entry points (packed host fast path) ---------------
    def test_hashed(self, h: np.ndarray) -> np.ndarray:
        """test_keys over precomputed XXH3 values (of the canonical key)."""
        idx = h % np.uint64(self.size)
        word = (idx >> np.uint64(5)).astype(np.int64)
        bit = (idx & np.uint64(31)).astype(np.uint32)
        return ((self.words[word] >> bit) & np.uint32(1)).astype(bool)

    def increment_hashed(self, h: np.ndarray, counters: np.ndarray) -> None:
        """increment_keys over precomputed XXH3 values."""
        if not self.mode or len(h) == 0:
            return
        is_set, cnt_idx = self._count_from_idx(h % np.uint64(self.size))
        from ..utils import native

        idx, vals = cnt_idx[is_set], counters.astype(np.uint32)[is_set]
        if not native.scatter_add_u32(self.counts, idx, vals):
            np.add.at(self.counts, idx, vals)

    def count_slots(self, kmers: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Public (is_set, counter index) resolution — the
        sample-independent half of get_counts; any counter plane then
        answers with ``plane[idx]`` where is_set (batch genotyping)."""
        return self._count_indices(kmers)

    def increment_keys(self, kmers: np.ndarray, counters: np.ndarray) -> None:
        if not self.mode or len(kmers) == 0:
            return
        is_set, cnt_idx = self._count_indices(kmers)
        from ..utils import native

        idx, vals = cnt_idx[is_set], counters.astype(np.uint32)[is_set]
        if not native.scatter_add_u32(self.counts, idx, vals):
            np.add.at(self.counts, idx, vals)

    def get_counts(self, kmers: np.ndarray) -> np.ndarray:
        """uint16 counter per k-mer, 0 where bit unset or write mode."""
        if not self.mode or len(kmers) == 0:
            return np.zeros(len(kmers), dtype=np.uint16)
        is_set, cnt_idx = self._count_indices(kmers)
        out = np.zeros(len(kmers), dtype=np.uint16)
        out[is_set] = (self.counts[cnt_idx[is_set]] & np.uint32(0xFFFF)).astype(np.uint16)
        return out

    # -- serialization (own sharded-friendly format) -----------------------
    def state(self) -> dict:
        st = {"size": np.int64(self.size), "mode": np.int64(self.mode), "words": self.words}
        if self.mode:
            st["counts"] = self.counts  # rank rebuilt on load
        return st

    @classmethod
    def from_state(cls, st: dict, prefix: str = "") -> "BF":
        bf = cls(int(st[prefix + "size"]))
        bf.words = np.asarray(st[prefix + "words"], dtype=np.uint32)
        if int(st[prefix + "mode"]):
            bf.switch_mode()
            bf.counts[:] = np.asarray(st[prefix + "counts"], dtype=np.uint32)
        return bf
