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

import numpy as np

from ..ops.seq import canonical, is_acgt, pack_2bit, truncate_at_nul


def _keys(kmers: np.ndarray) -> list[bytes]:
    ck = truncate_at_nul(canonical(kmers))
    return [row.tobytes().rstrip(b"\x00") for row in ck]


class KMAP:
    def __init__(self):
        self._kmers: dict[bytes, int] = {}
        self._fast: dict[int, np.ndarray] = {}  # probe width -> sorted void keys
        self._slots: dict[bytes, int] | None = None  # key -> insertion index

    @property
    def kmers(self) -> dict:
        return self._kmers

    @kmers.setter
    def kmers(self, d: dict) -> None:
        # callers swap whole dicts in (batch planes, index load); the
        # membership cache is keyed on the KEY SET and must not survive
        self._kmers = d
        self._fast.clear()
        self._slots = None

    def _fast_index(self, k: int):
        """Sorted packed view of the pure-ACGT length-k keys, for a
        vectorized membership test: a pure canonical probe of length k can
        only ever equal one of these (NUL-truncated or IUPAC keys differ
        in at least one byte).  Comparison order is the void view's
        memcmp — internally consistent, which is all searchsorted needs.

        Guarded by the key COUNT: direct insertions into the dict (e.g.
        index load loops) bypass the kmers setter, and a stale cache
        would silently drop counts — a len change always invalidates."""
        if self._fast.get("_n") != len(self._kmers):
            self._fast.clear()
            self._fast["_n"] = len(self._kmers)
        fi = self._fast.get(k)
        if fi is None:
            keys = [kb for kb in self.kmers if len(kb) == k]
            if keys:
                arr = np.frombuffer(b"".join(keys), np.uint8).reshape(-1, k)
                ok = is_acgt(arr)
                arr = arr[ok]
            if keys and arr.shape[0]:
                packed = np.ascontiguousarray(pack_2bit(arr))
                voids = packed.view(f"V{packed.shape[1] * 8}").ravel()
                voids = np.sort(voids)
            else:
                voids = np.zeros(0, dtype="V8")
            fi = self._fast[k] = voids
        return fi

    def _match_mask(self, kmers: np.ndarray, ck: np.ndarray) -> "np.ndarray | None":
        """Boolean mask of probes that CAN be map members (pure-ACGT probes
        filtered by the packed membership test; non-pure probes pass
        through as True and take the per-row path)."""
        n, k = kmers.shape
        if n < 1024:  # not worth the packing below this
            return None
        voids = self._fast_index(k)
        pure = is_acgt(ck)
        maybe = np.ones(n, dtype=bool)
        if pure.any():
            packed = np.ascontiguousarray(pack_2bit(ck[pure]))
            pv = packed.view(f"V{packed.shape[1] * 8}").ravel()
            if voids.shape[0]:
                pos = np.searchsorted(voids, pv)
                pos_c = np.minimum(pos, voids.shape[0] - 1)
                found = (pos < voids.shape[0]) & (voids[pos_c] == pv)
            else:
                found = np.zeros(pv.shape[0], dtype=bool)
            maybe[pure] = found
        return maybe

    def add_keys(self, kmers: np.ndarray) -> None:
        self._fast.clear()
        self._slots = None
        for key in _keys(kmers):
            self.kmers[key] = 0

    def increment_keys(self, kmers: np.ndarray, counters: np.ndarray) -> None:
        d = self.kmers
        ck = truncate_at_nul(canonical(kmers))
        maybe = self._match_mask(kmers, ck)
        if maybe is not None:
            if not maybe.any():
                return
            ck = ck[maybe]
            counters = np.asarray(counters)[maybe]
        for row, c in zip(ck, counters.tolist()):
            key = row.tobytes().rstrip(b"\x00")
            v = d.get(key)
            if v is not None:
                d[key] = (v + int(c)) & 0xFFFFFFFF

    def _packed_index(self, k: int):
        """Sorted packed view of the pure-ACGT length-k keys PLUS the key
        objects in that order — the packed-probe increment path resolves
        hits by native binary search and folds into the dict by position.
        Row order is lexicographic on the uint64 words, which equals ASCII
        k-mer order under pack_2bit's layout.  Guarded by key count like
        :meth:`_fast_index`."""
        from ..utils import native

        if self._fast.get("_n") != len(self._kmers):
            self._fast.clear()
            self._fast["_n"] = len(self._kmers)
        e = self._fast.get(("pk", k))
        if e is None:
            keys = [kb for kb in self.kmers if len(kb) == k]
            if keys:
                arr = np.frombuffer(b"".join(keys), np.uint8).reshape(-1, k)
                ok = is_acgt(arr)
                idx_ok = np.nonzero(ok)[0]
                packed = np.ascontiguousarray(pack_2bit(arr[ok]))
            if keys and packed.shape[0]:
                perm = native.argsort_u64rows(packed)
                if perm is None:
                    return None
                rows = np.ascontiguousarray(packed[perm])
                korder = [keys[i] for i in idx_ok[perm].tolist()]
            else:
                rows = np.zeros((0, (k + 31) // 32), dtype=np.uint64)
                korder = []
            e = self._fast[("pk", k)] = (rows, korder)
        return e

    def increment_packed(self, probes: np.ndarray, counters: np.ndarray,
                         k: int) -> bool:
        """increment_keys over 2-bit packed canonical pure-ACGT probes
        ((N, ceil(k/32)) uint64) — no ASCII matrices, native search.
        Returns False when the native library is unavailable (caller runs
        the ASCII path).  Exact: a pure-ACGT probe can only ever match a
        pure-ACGT length-k key (NUL-truncated keys are shorter, IUPAC keys
        differ in a byte), and the per-key fold wraps mod 2^32 exactly
        like the per-store wrap (addition is associative mod 2^32)."""
        from ..utils import native

        pk = self._packed_index(k)
        if pk is None:
            return False
        rows, korder = pk
        if not korder or probes.shape[0] == 0:
            return True
        pos = native.search_u64rows(rows, probes)
        if pos is None:
            return False
        hit = pos >= 0
        if not hit.any():
            return True
        agg = np.zeros(len(korder), dtype=np.uint32)
        vals = np.asarray(counters, dtype=np.uint32)[hit]
        if not native.scatter_add_u32(agg, pos[hit], vals):
            np.add.at(agg, pos[hit], vals)
        d = self._kmers
        for i in np.nonzero(agg)[0].tolist():
            key = korder[i]
            d[key] = (d[key] + int(agg[i])) & 0xFFFFFFFF
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
        if self._slots is None or len(self._slots) != len(self._kmers):
            self._slots = {k: i for i, k in enumerate(self._kmers)}
        sm = self._slots
        found = np.zeros(len(kmers), dtype=bool)
        out = np.zeros(len(kmers), dtype=np.int64)
        ck = truncate_at_nul(canonical(kmers))
        maybe = self._match_mask(kmers, ck)
        rows = np.nonzero(maybe)[0] if maybe is not None else range(len(kmers))
        for i in rows:
            v = sm.get(ck[i].tobytes().rstrip(b"\x00"))
            if v is not None:
                found[i] = True
                out[i] = v
        return found, out

    def get_counts(self, kmers: np.ndarray) -> np.ndarray:
        d = self.kmers
        out = np.zeros(len(kmers), dtype=np.int64)
        ck = truncate_at_nul(canonical(kmers))
        maybe = self._match_mask(kmers, ck)
        rows = np.nonzero(maybe)[0] if maybe is not None else range(len(kmers))
        for i in rows:
            key = ck[i].tobytes().rstrip(b"\x00")
            v = d.get(key)
            if v is not None:
                # stored as uint32, read back as signed int (kmap.hpp:119-121)
                out[i] = v - (1 << 32) if v >= (1 << 31) else v
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
