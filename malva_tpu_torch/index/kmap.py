"""Exact canonical k-mer -> count map for reference-allele k-mers.

Mirrors the reference KMAP (reference: kmap.hpp:46-132): keys are the
canonical form of the k-mer *as a C string*, i.e. truncated at the first
NUL byte (which appears when the canonical form is a reverse complement
containing non-ACGTN characters).  ``add_key`` resets the value to 0;
``increment`` only touches existing keys and wraps mod 2^32;
``get_count`` reinterprets the stored value as a signed int (upstream
stores into ``int``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..ops.seq import canonical, is_acgt, pack_2bit, truncate_at_nul, unpack_2bit
from ..utils import native
from ..utils.timing import count


def _keys(kmers: np.ndarray) -> list[bytes]:
    ck = truncate_at_nul(canonical(kmers))
    return [row.tobytes().rstrip(b"\x00") for row in ck]


# get_counts copies every value once (np.fromiter, ~40 ns a key) where its
# hits are at least 1/SNAPSHOT_HITS of the map's keys, else it reads each
# hit's value by its key (~1 us a key in a map of a million keys)
SNAPSHOT_HITS = 16


class _KeyView(NamedTuple):
    """The map's keys arranged for search.  ``k``: the keys' most common
    length.  ``rows``: the pure-ACGT length-``k`` keys, 2-bit packed
    (``pack_2bit``) and sorted by ``native.argsort_u64rows``
    (lexicographic on the uint64 words, which is ASCII k-mer order), or
    None without the native library or keys.  ``order``: each row's
    position in the dict's insertion order.  ``rest``: every other key
    (IUPAC bytes, NUL-truncated; all keys without the library) -> its
    position.  ``n``: the key count it was built for."""

    n: int
    k: int
    rows: "np.ndarray | None"
    order: np.ndarray
    rest: dict


def _key_view(kmers: dict) -> _KeyView:
    keys = list(kmers)
    lens = np.fromiter(map(len, keys), np.int64, len(keys))
    k = int(np.bincount(lens).argmax()) if keys else 0
    searched = np.zeros(len(keys), dtype=bool)
    rows, order = None, np.zeros(0, dtype=np.int64)
    if keys and native.load() is not None:
        full = np.flatnonzero(lens == k)
        blob = b"".join(keys if full.shape[0] == len(keys) else [keys[i] for i in full.tolist()])
        arr = np.frombuffer(blob, np.uint8).reshape(-1, k)
        pure = is_acgt(arr)
        packed = pack_2bit(arr[pure])
        perm = native.argsort_u64rows(packed)
        rows = np.ascontiguousarray(packed[perm])
        order = full[pure][perm]
        searched[order] = True
    rest = {keys[i]: i for i in np.flatnonzero(~searched).tolist()}
    return _KeyView(len(keys), k, rows, order, rest)


class KMAP:
    def __init__(self):
        self._kmers: dict[bytes, int] = {}
        self._view: _KeyView | None = None

    @property
    def kmers(self) -> dict:
        return self._kmers

    @kmers.setter
    def kmers(self, d: dict) -> None:
        # callers swap whole dicts in (batch planes, index load); the key
        # view is of the KEY SET and must not survive
        self._kmers = d
        self._view = None

    def key_view(self) -> _KeyView:
        """The sorted view of the keys (:class:`_KeyView`), built where
        none is cached.  Guarded by the key COUNT: direct insertions into
        the dict (index load loops) bypass the kmers setter; updates of
        values keep the dict's order and the view.  It holds no values:
        every query reads them anew."""
        v = self._view
        if v is None or v.n != len(self._kmers):
            v = self._view = _key_view(self._kmers)
        return v

    def _positions(self, kmers: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(canonical NUL-truncated probes, each one's key position in
        insertion order or -1).  A probe whose truncated bytes are pure
        ACGT of the view's length can only equal a row of the view (a
        NUL-truncated key is shorter, an IUPAC key differs in a byte):
        those take one native search (``kmap.packed_queries``); every
        other probe a lookup in ``rest`` (``kmap.dict_queries``)."""
        ck = truncate_at_nul(canonical(kmers))
        n, w = ck.shape
        pos = np.full(n, -1, dtype=np.int64)
        v = self.key_view()
        if v.rows is not None and w >= v.k:
            head = ck[:, : v.k]
            pure = is_acgt(head) & (ck[:, v.k :] == 0).all(axis=1)
        else:
            pure = np.zeros(n, dtype=bool)
        if pure.any():
            at = native.search_u64rows(v.rows, pack_2bit(head[pure]))
            found = at >= 0
            at[found] = v.order[at[found]]
            pos[pure] = at
        slow = np.flatnonzero(~pure).tolist()
        for i in slow:
            pos[i] = v.rest.get(ck[i].tobytes().rstrip(b"\x00"), -1)
        count("kmap.packed_queries", n - len(slow))
        count("kmap.dict_queries", len(slow))
        return ck, pos

    def add_keys(self, kmers: np.ndarray) -> None:
        self._view = None
        for key in _keys(kmers):
            self.kmers[key] = 0

    def increment_keys(self, kmers: np.ndarray, counters: np.ndarray) -> None:
        d = self.kmers
        ck, pos = self._positions(kmers)
        hit = pos >= 0
        for row, c in zip(ck[hit], np.asarray(counters)[hit].tolist()):
            key = row.tobytes().rstrip(b"\x00")
            d[key] = (d[key] + int(c)) & 0xFFFFFFFF

    def increment_packed(self, probes: np.ndarray, counters: np.ndarray,
                         k: int) -> bool:
        """increment_keys over 2-bit packed canonical pure-ACGT probes
        ((N, ceil(k/32)) uint64) — no ASCII matrices, native search.
        Returns False when the native library is unavailable (caller runs
        the ASCII path).  Exact: a pure-ACGT probe can only ever match a
        pure-ACGT length-k key (NUL-truncated keys are shorter, IUPAC keys
        differ in a byte), and the per-key fold wraps mod 2^32 exactly
        like the per-store wrap (addition is associative mod 2^32).  The
        keys it writes are the hit rows unpacked: a pure key's bytes."""
        v = self.key_view()
        if v.rows is None or v.k != k:
            return False
        count("kmap.packed_queries", probes.shape[0])
        if not v.rows.shape[0] or probes.shape[0] == 0:
            return True
        at = native.search_u64rows(v.rows, probes)
        hit = at >= 0
        if not hit.any():
            return True
        agg = np.zeros(v.rows.shape[0], dtype=np.uint32)
        native.scatter_add_u32(agg, at[hit], np.asarray(counters, dtype=np.uint32)[hit])
        rows = np.flatnonzero(agg)
        keys = unpack_2bit(v.rows[rows], k).tobytes()
        d = self._kmers
        for j, add in enumerate(agg[rows].tolist()):
            key = keys[j * k : (j + 1) * k]
            d[key] = (d[key] + add) & 0xFFFFFFFF
        return True

    # -- batch counter planes ----------------------------------------------
    # A "plane" is one sample's counter VALUES as a uint32 array in key
    # insertion order — 4 B/key instead of a full per-sample dict copy
    # (pipeline.call_batch keeps N of these alive at once).

    def snapshot_values(self) -> np.ndarray:
        """Current counter values, in the order get_slots indexes."""
        return np.fromiter(self._kmers.values(), dtype=np.uint32,
                           count=len(self._kmers))

    def get_slots(self, kmers: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(found bool, slot int64) per query — the sample-independent half
        of get_counts: canonicalization + membership resolved once, then
        any plane answers with ``plane[slot]`` (reinterpreted signed, as
        get_counts does)."""
        _, pos = self._positions(kmers)
        found = pos >= 0
        return found, np.where(found, pos, 0)

    def get_counts(self, kmers: np.ndarray) -> np.ndarray:
        ck, pos = self._positions(kmers)
        hits = np.flatnonzero(pos >= 0)
        out = np.zeros(len(pos), dtype=np.int64)
        if hits.shape[0] * SNAPSHOT_HITS >= len(self._kmers):
            vals = self.snapshot_values()[pos[hits]]
        else:
            d = self._kmers
            vals = np.fromiter((d[ck[i].tobytes().rstrip(b"\x00")] for i in hits.tolist()),
                               dtype=np.uint32, count=hits.shape[0])
            count("kmap.dict_queries", hits.shape[0])
        # stored as uint32, read back as signed int (kmap.hpp:119-121)
        out[hits] = vals.view(np.int32)
        return out

    def __len__(self) -> int:
        return len(self.kmers)

    # -- serialization -----------------------------------------------------
    def state(self) -> dict:
        keys = list(self.kmers.keys())
        maxlen = max((len(k) for k in keys), default=0)
        if keys and all(len(k) == maxlen for k in keys):
            # uniform-length keys (the norm: full-k ACGT/IUPAC strings):
            # one join instead of a per-row numpy fill
            arr = np.frombuffer(b"".join(keys), dtype=np.uint8).reshape(
                len(keys), maxlen)
        else:
            arr = np.zeros((len(keys), maxlen), dtype=np.uint8)
            for i, k in enumerate(keys):
                arr[i, : len(k)] = np.frombuffer(k, dtype=np.uint8)
        vals = np.fromiter(self.kmers.values(), dtype=np.uint32, count=len(keys))
        return {"keys": arr, "vals": vals}

    @classmethod
    def from_state(cls, st: dict, prefix: str = "") -> "KMAP":
        km = cls()
        arr = np.ascontiguousarray(np.asarray(st[prefix + "keys"], dtype=np.uint8))
        vals = np.asarray(st[prefix + "vals"], dtype=np.uint32)
        n, L = arr.shape if arr.ndim == 2 else (0, 0)
        if n == 0:
            return km
        # bytes-slice loop instead of per-row arr[i].tobytes(): ~4x on the
        # 7.8M-key chr-scale map; NUL-padded (shorter) keys are rare and
        # rstripped only where a zero byte exists
        data = arr.tobytes()
        kmers = km.kmers
        vl = vals.tolist()
        # per-row min == 0 detects NUL padding with one (n,) temp instead
        # of two n*L boolean temps (~270 MB each at 7.8M x 35)
        row_has_nul = arr.min(axis=1) == 0
        if not row_has_nul.any():
            for i, v in enumerate(vl):
                kmers[data[i * L : (i + 1) * L]] = v
        else:
            short = row_has_nul.tolist()
            for i, v in enumerate(vl):
                b = data[i * L : (i + 1) * L]
                kmers[b.rstrip(b"\x00") if short[i] else b] = v
        return km
