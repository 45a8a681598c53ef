"""Variant blocks + haplotype-aware k-mer signature extraction.

Host-side mirror of the reference's algorithmic core (reference:
var_block.hpp:61-798): variants that are (k/2)-near are grouped into a
block; for every variant, combinations of nearby non-overlapping variants
are grown left/right (with back-tracking when a new variant overlaps a
combination's tail), sample-consistent allele combinations (haplotypes)
are enumerated (unphased genotypes expand over both choices per site,
deduplicated), and each haplotype is rendered into one or more k-length
signature strings centered on the mid variant's allele, padded/trimmed
with reference flanks.

Divergences from upstream (all UB there, defined here):
* back-tracking that empties a combination (var_block.hpp:496-501 reads
  ``back()`` of an empty vector) stops cleanly instead;
* GT allele indices pointing at dropped symbolic alternates
  (variant.hpp:221 reads past ``alts``) clamp to the reference allele;
* reference-flank slices that would start before the contig
  (var_block.hpp:178-181 with a near-start variant in the combination)
  clamp to position 0.

The output VK_GROUP is ``{var_index: {allele_index: [signature, ...]}}``
where a signature is a list of k-mer byte strings.
"""

from __future__ import annotations

import sys

import numpy as np

from .variant import Variant

VK_GROUP = dict  # {int: {int: list[list[bytes]]}}


def are_overlapping(v1: Variant, v2: Variant) -> bool:
    """var_block.hpp:408-412"""
    return v1.ref_pos <= v2.ref_pos < v1.ref_pos + v1.ref_size


def are_near(v1: Variant, v2: Variant, k: int, sum_to_add: int = 0) -> bool:
    """var_block.hpp:417-423"""
    return (
        v1.ref_pos + v1.ref_size - v1.min_size - 1 + sum_to_add + (k + 1) // 2
        >= v2.ref_pos
    )


_warned_oob_allele = False


def _get_allele(v: Variant, i: int) -> bytes:
    global _warned_oob_allele
    if i > len(v.alts):
        if not _warned_oob_allele:
            print(
                f"[malva-tpu] warning: GT allele index {i} beyond ALT count at "
                f"{v.seq_name}:{v.ref_pos + 1} (symbolic ALT dropped?); using REF",
                file=sys.stderr,
            )
            _warned_oob_allele = True
        return v.ref_sub
    return v.get_allele(i)


def _dedup_rows(mat: np.ndarray) -> np.ndarray:
    """Unique rows (any order) without np.unique's void-dtype sort —
    sorting 56 KB rows of a 30k-sample cohort block is pathologically
    slow; hashing row bytes is linear.  uint8 cast when values fit."""
    if mat.shape[0] <= 1:
        return mat
    if int(mat.max(initial=0)) < 256 and int(mat.min(initial=0)) >= 0:
        mat = np.ascontiguousarray(mat, dtype=np.uint8)
    else:
        mat = np.ascontiguousarray(mat)
    L = mat.shape[1] * mat.itemsize
    data = mat.tobytes()
    seen = set()
    keep = []
    for i in range(mat.shape[0]):
        b = data[i * L : (i + 1) * L]
        if b not in seen:
            seen.add(b)
            keep.append(i)
    return mat[keep]


def _dedup_rows_fast(mat: np.ndarray) -> np.ndarray:
    """Unique rows of a uint8 matrix, fully vectorized: rows pack 8 bytes
    per uint64 word and deduplicate by sort.  The many-key lexsort loses
    to the linear bytes-hash loop once rows are wide AND the matrix is
    big (measured crossover ~32 B/row at ~30k cohort rows), so that
    regime — and non-uint8 input — falls back to :func:`_dedup_rows`.
    Tiny matrices (the common case: per-variant window projections on
    sparse VCFs) skip numpy entirely — a bytes-set loop over <=24 rows
    is ~10x cheaper than the pad+view+lexsort pipeline."""
    u, L = mat.shape
    if u <= 1:
        return mat
    if u <= 24:
        mat = np.ascontiguousarray(mat)
        Lb = L * mat.itemsize
        data = mat.tobytes()
        seen = set()
        keep = []
        for i in range(u):
            b = data[i * Lb : (i + 1) * Lb]
            if b not in seen:
                seen.add(b)
                keep.append(i)
        return mat if len(keep) == u else mat[keep]
    if mat.dtype != np.uint8 or (L > 32 and u > 4096):
        return _dedup_rows(mat)
    w = (L + 7) // 8
    pad = np.zeros((u, w * 8), np.uint8)
    pad[:, :L] = mat
    keys = pad.view(np.uint64)  # (u, w); any bijective packing works
    if w == 1:
        _, first = np.unique(keys[:, 0], return_index=True)
        return np.ascontiguousarray(mat[first])
    order = np.lexsort(tuple(keys[:, j] for j in range(w - 1, -1, -1)))
    s = keys[order]
    sel = np.concatenate([[True], np.any(s[1:] != s[:-1], axis=1)])
    return np.ascontiguousarray(mat[order[sel]])


class VB:
    """A block of nearby variants (var_block.hpp:61)."""

    def __init__(self, k: int, error_rate: float):
        self.variants: list[Variant] = []
        self.k = k
        self.error_rate = error_rate

    def is_near_to_last(self, v: Variant) -> bool:
        return are_near(self.variants[-1], v, self.k)

    def add_variant(self, v: Variant) -> None:
        self.variants.append(v)

    def empty(self) -> bool:
        return not self.variants

    def clear(self) -> None:
        self.variants = []

    # -- combination growth (var_block.hpp:436-624) ------------------------
    def _grow_combs(self, i: int, direction: int) -> list[list[int]]:
        """direction +1: right combs; -1: left combs (indices outward)."""
        variants = self.variants
        mid_v = variants[i]
        combs: list[list[int]] = []
        sums: list[int] = []
        k = self.k

        if direction > 0:
            indices = range(i + 1, len(variants))
        else:
            indices = range(i - 1, -1, -1)

        def overlapping(a: Variant, b: Variant) -> bool:
            # right: are_overlapping(earlier, later) = (last_in_comb, curr);
            # left: (curr, last_in_comb) — curr is the earlier one.
            return are_overlapping(a, b) if direction > 0 else are_overlapping(b, a)

        def near(curr: Variant, s: int) -> bool:
            return (
                are_near(mid_v, curr, k, s) if direction > 0 else are_near(curr, mid_v, k, s)
            )

        for j in indices:
            curr = variants[j]
            if not curr.is_present:
                continue
            if direction > 0:
                if are_overlapping(mid_v, curr):
                    continue
            else:
                if are_overlapping(curr, mid_v):
                    continue

            if not combs:
                if near(curr, 0):
                    combs.append([j])
                    sums.append(curr.ref_size - curr.min_size)
                continue

            added = False
            for c in range(len(combs)):
                last = variants[combs[c][-1]]
                if not overlapping(last, curr):
                    added = True
                    if near(curr, sums[c]):
                        combs[c].append(j)
                        sums[c] += curr.ref_size - curr.min_size
            if not added:
                new_combs: list[list[int]] = []
                new_sums: list[int] = []
                for c in range(len(combs)):
                    nc = list(combs[c])
                    ns = sums[c]
                    while nc and overlapping(variants[nc[-1]], curr):
                        popped = variants[nc.pop()]
                        ns -= popped.ref_size - popped.min_size
                    nc.append(j)
                    if near(curr, ns):
                        added = True
                        new_combs.append(nc)
                        new_sums.append(ns + curr.ref_size - curr.min_size)
                combs.extend(new_combs)
                sums.extend(new_sums)
                if not added:
                    break  # halt: nothing further can be near
        return combs

    def _combine_combs(
        self, left: list[list[int]], right: list[list[int]], i: int
    ) -> list[list[int]]:
        """var_block.hpp:630-677"""
        full: list[list[int]] = []
        if not left and not right:
            return [[i]]
        if not left:
            for rc in right:
                full.append([i] + rc)
            return full
        for lc in left:
            base = lc[::-1] + [i]
            if not right:
                full.append(base)
            else:
                for rc in right:
                    full.append(base + rc)
        return full

    def _get_ref_subs(self, comb: list[int], reference: bytes) -> list[bytes]:
        """var_block.hpp:682-702"""
        subs: list[bytes] = []
        last_end = -1
        for index in comb:
            v = self.variants[index]
            if last_end == -1:
                last_end = v.ref_pos + v.ref_size
                continue
            subs.append(reference[last_end : v.ref_pos])
            last_end = v.ref_pos + v.ref_size
        return subs

    def _unique_profiles(self, haploid: bool) -> None:
        """Deduplicate individuals by their joint genotype over the block's
        present variants.

        The reference iterates build_alleles_combs over every individual
        (var_block.hpp:743); since results land in a dedup set, iterating
        the *unique* joint genotypes is equivalent and turns cohort-scale
        sample counts (30k in the SARS-CoV-2 example) into a handful of
        profiles per block.  Populates self._profiles_mat (one row per
        unique individual profile) and self._present_pos (variant index ->
        column group in the profile matrix).
        """
        present = [
            j for j, v in enumerate(self.variants) if v.is_present and v.n_individuals
        ]
        self._present_pos = {j: p for p, j in enumerate(present)}
        cols = [self.variants[j] for j in present]
        if cols:
            n_ind = cols[0].n_individuals
            hi = max(
                max(int(v.gt_a1.max(initial=0)), int(v.gt_a2.max(initial=0)))
                for v in cols
            )
            dt = np.uint8 if hi < 256 else np.int32
            if haploid:
                mat = np.empty((n_ind, len(cols)), dtype=dt)
                for p, v in enumerate(cols):
                    mat[:, p] = v.gt_a1
            else:
                mat = np.empty((n_ind, 3 * len(cols)), dtype=dt)
                for p, v in enumerate(cols):  # columns grouped per variant
                    mat[:, 3 * p] = v.gt_a1
                    mat[:, 3 * p + 1] = v.gt_a2
                    mat[:, 3 * p + 2] = v.phase
            # _dedup_rows_fast dispatches: vectorized sort-dedup for rows
            # <= 256 B, the linear bytes-hash loop for the huge-block wide
            # rows where a many-key lexsort loses
            self._profiles_mat = _dedup_rows_fast(mat)
        else:
            self._profiles_mat = np.zeros((0, 0), dtype=np.uint8)

    @staticmethod
    def _project_dedup(mat: np.ndarray, pos: dict[int, int], window: list[int],
                       haploid: bool):
        """Project a profile matrix onto the column groups of ``window``
        (1 column per variant haploid, 3 diploid) and deduplicate rows.
        Returns (wmat, local_pos) with local_pos mapping variant index ->
        group index in wmat."""
        if haploid:
            wcols = [pos[j] for j in window]
        else:
            wcols = []
            for j in window:
                p = pos[j]
                wcols.extend((3 * p, 3 * p + 1, 3 * p + 2))
        wmat = _dedup_rows_fast(np.ascontiguousarray(mat[:, wcols]))
        return wmat, {j: w for w, j in enumerate(window)}

    def _alleles_of(self, j: int) -> list[bytes]:
        """Per-variant allele byte strings with the out-of-range clamp of
        :func:`_get_allele`, cached per extract_kmers call."""
        t = self._atab.get(j)
        if t is None:
            v = self.variants[j]
            t = self._atab[j] = [v.get_allele(i) for i in range(len(v.alts) + 1)]
        return t

    def _allele(self, j: int, a: int) -> bytes:
        t = self._alleles_of(j)
        return t[a] if a < len(t) else _get_allele(self.variants[j], a)

    def _build_alleles_combs(
        self, comb: list[int], wmat: np.ndarray, local_pos: dict[int, int],
        haploid: bool,
    ) -> set[tuple[bytes, ...]]:
        """var_block.hpp:734-786 over unique genotype profiles, with
        incremental dedup replacing the explicit 2^n haplotype table of
        combine_haplotypes (same final set).

        Haplotype enumeration runs entirely in allele-INDEX space (small
        int tuples — cheap to hash, vectorizable phased split); allele
        byte strings are rendered once per unique index combination.  The
        final dedup stays on the byte tuples, so combinations that render
        identically (e.g. an out-of-range GT clamped to REF) still
        collapse exactly as the reference's string set does."""
        aacs: set[tuple[bytes, ...]] = set()
        al = self._allele
        comb_pos = [local_pos[j] for j in comb]
        if len(comb) == 1:
            # single-variant combination (the overwhelmingly common case
            # on sparse chr-scale VCFs): the 2^1 unphased selections of
            # (a1, a2) equal the phased haplotype split, so the unique
            # allele indices over BOTH gt columns are the whole answer
            p = comb_pos[0]
            j = comb[0]
            if haploid:
                vals = set(wmat[:, p].tolist())
            else:
                vals = set(wmat[:, 3 * p].tolist())
                vals.update(wmat[:, 3 * p + 1].tolist())
            return {(al(j, int(a)),) for a in vals}
        idx_set: set[tuple[int, ...]]
        if haploid:
            sub = _dedup_rows_fast(np.ascontiguousarray(wmat[:, comb_pos]))
            idx_set = set(map(tuple, sub.tolist()))
        else:
            cols = []
            for p in comb_pos:
                cols.extend((3 * p, 3 * p + 1, 3 * p + 2))
            sub = _dedup_rows_fast(np.ascontiguousarray(wmat[:, cols]))
            a1m, a2m = sub[:, 0::3], sub[:, 1::3]
            phased = (sub[:, 2::3] != 0).all(axis=1)
            idx_set = set()
            if phased.any():
                haps = _dedup_rows_fast(
                    np.ascontiguousarray(np.concatenate([a1m[phased], a2m[phased]]))
                )
                idx_set.update(map(tuple, haps.tolist()))
            if not phased.all():
                un = ~phased
                for r1, r2 in zip(a1m[un].tolist(), a2m[un].tolist()):
                    # all 2^n selections, deduplicated level by level
                    partial: set[tuple[int, ...]] = {()}
                    for x, y in zip(r1, r2):
                        if x == y:
                            partial = {t + (x,) for t in partial}
                        else:
                            partial = {t + (a,) for t in partial for a in (x, y)}
                    idx_set |= partial
        for t in idx_set:
            aacs.add(tuple(al(j, a) for j, a in zip(comb, t)))
        return aacs

    # -- signature extraction (var_block.hpp:95-219) -----------------------
    def _extract_single(self, reference: bytes, haploid: bool) -> dict:
        """Single-variant block fast path — the dominant block shape on
        sparse chr-scale VCFs (~70% of blocks).  The general machinery
        (profile matrix, window projections, combination growth) all
        collapses: combs == [[0]], and the sample-consistent allele set
        is exactly the unique GT allele indices (both columns diploid —
        the 2^1 unphased split equals the phased split for one site).
        Byte-identical to the general path by construction."""
        k = self.k
        v = self.variants[0]
        kmers: dict[int, dict[int, list[list[bytes]]]] = {0: {}}
        if not v.is_present or v.ref_pos < k or v.ref_pos > len(reference) - k:
            return kmers
        self._atab = {}
        vals = set(v.gt_a1.tolist())
        if not haploid:
            vals.update(v.gt_a2.tolist())
        aacs = {(self._allele(0, int(a)),) for a in vals}
        _kmers: dict[int, list[list[bytes]]] = {}
        self._render_comb(0, [0], [], aacs, reference, _kmers)
        kmers[0] = _kmers
        return kmers

    def extract_kmers(self, reference: bytes, haploid: bool) -> dict:
        k = self.k
        if len(self.variants) == 1:
            return self._extract_single(reference, haploid)
        self._unique_profiles(haploid)
        self._atab: dict[int, list[bytes]] = {}
        kmers: dict[int, dict[int, list[list[bytes]]]] = {}
        n = len(self.variants)
        # Window dedup is two-level: once per CHUNK of consecutive variants
        # over the union of their combinations' columns (amortizes the
        # dedup over the full unique-profile matrix, which can be 10k+ rows
        # on cohort data), then per variant from that much smaller matrix.
        CHUNK = 64
        for base in range(0, n, CHUNK):
            members: list[int] = []
            combs_of: dict[int, list[list[int]]] = {}
            for v_index in range(base, min(base + CHUNK, n)):
                kmers[v_index] = {}
                v = self.variants[v_index]
                if (
                    not v.is_present
                    or v.ref_pos < k
                    or v.ref_pos > len(reference) - k
                ):
                    continue
                right_combs = self._grow_combs(v_index, +1)
                left_combs = self._grow_combs(v_index, -1)
                combs = self._combine_combs(left_combs, right_combs, v_index)
                members.append(v_index)
                combs_of[v_index] = combs
            if not members:
                continue
            cwindow = sorted({j for cs in combs_of.values() for c in cs for j in c})
            cmat, cpos = self._project_dedup(
                self._profiles_mat, self._present_pos, cwindow, haploid
            )
            for v_index in members:
                self._extract_for_variant(
                    v_index, combs_of[v_index], cmat, cpos, reference, haploid, kmers
                )
        return kmers

    def _extract_for_variant(self, v_index, combs, cmat, cpos, reference,
                             haploid, kmers) -> None:
        k = self.k
        v = self.variants[v_index]
        _kmers: dict[int, list[list[bytes]]] = {}
        window = sorted({j for c in combs for j in c})
        wmat, local_pos = self._project_dedup(cmat, cpos, window, haploid)
        for comb in combs:
            ref_subs = self._get_ref_subs(comb, reference)
            aacs = self._build_alleles_combs(comb, wmat, local_pos, haploid)
            self._render_comb(v_index, comb, ref_subs, aacs, reference, _kmers)
        kmers[v_index] = _kmers

    def _render_comb(self, v_index, comb, ref_subs, aacs, reference,
                     _kmers) -> None:
        """Render each allele combination of ``comb`` into its signature
        k-mer strings (the string-assembly half of var_block.hpp:95-219)."""
        k = self.k
        v = self.variants[v_index]
        for aac in aacs:
                ksss: list[bytes] = []
                if len(aac) == 1 and len(aac[0]) >= k:
                    mid_allele = aac[0]
                    for p in range(len(mid_allele) - k + 1):
                        ksss.append(mid_allele[p : p + k])
                else:
                    kmer = b""
                    mid_pos_in_kmer = 0
                    mid_allele = b""
                    for j in range(len(aac)):
                        rs = ref_subs[j] if j < len(ref_subs) else b""
                        if comb[j] == v_index:
                            mid_pos_in_kmer = len(kmer)
                            mid_allele = aac[j]
                        kmer += aac[j] + rs

                    first_part = mid_pos_in_kmer + len(mid_allele) // 2
                    second_part = len(kmer) - first_part
                    missing_prefix = k // 2 - first_part
                    missing_suffix = (k + 1) // 2 - second_part

                    if missing_prefix >= 0:
                        first_var = self.variants[comb[0]]
                        start = first_var.ref_pos - missing_prefix
                        if start < 0:
                            start = 0  # upstream would throw (UB edge)
                        kmer = reference[start : first_var.ref_pos] + kmer
                    else:
                        kmer = kmer[-missing_prefix:]

                    if missing_suffix >= 0:
                        last_var = self.variants[comb[-1]]
                        pos = last_var.ref_pos + last_var.ref_size
                        kmer = kmer + reference[pos : pos + missing_suffix]
                    else:
                        kmer = kmer[: len(kmer) + missing_suffix]

                    ksss.append(kmer)

                allele_index = v.get_allele_index(mid_allele)
                _kmers.setdefault(allele_index, []).append(ksss)
