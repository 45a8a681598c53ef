"""In-memory variant model (mirrors reference variant.hpp:43-253).

One VCF record becomes a Variant: uppercased REF/ALTs with symbolic
('<'-prefixed) alternates dropped, float32 allele-frequency priors with the
reference-allele frequency computed as ``1 - sum(alt freqs)`` clamped at 0,
and the ``has_alts`` / ``is_present`` gating flags; its per-selected-sample
genotype pairs + phasing, decoded htslib-style, are rows of the batch's GT
step (``pipeline._gt_rows``), which the Variant holds only for the Python
extraction.
"""

from __future__ import annotations

import numpy as np

from ..io.vcf import VECTOR_END, VcfRecord


def _bcf_gt_allele(enc: int) -> int:
    return (enc >> 1) - 1


def _bcf_gt_is_phased(enc: int) -> bool:
    return bool(enc & 1)


# the GT arrays of a variant that holds none: only the Python extraction
# reads them (pipeline._extract_python)
EMPTY_I32 = np.zeros(0, dtype=np.int32)
EMPTY_BOOL = np.zeros(0, dtype=bool)


class Variant:
    __slots__ = (
        "seq_name", "ref_pos", "idx", "ref_sub", "alts", "quality", "filt",
        "info", "gt_a1", "gt_a2", "phase", "ref_size", "min_size", "max_size",
        "has_alts", "is_present", "frequencies", "coverages", "computed_gts",
    )

    def __init__(self, rec: VcfRecord, freq_key: str, uniform: bool):
        self.seq_name: str = rec.chrom
        self.ref_pos: int = rec.pos0
        self.idx: str = rec.idx
        self.ref_sub: bytes = rec.ref.upper().encode()
        self.ref_size: int = len(self.ref_sub)
        # symbolic alternates (<CN0>, <DEL>, ...) are dropped (variant.hpp:81-88)
        self.alts: list[bytes] = [
            a.upper().encode() for a in rec.alts_raw if not a.startswith("<")
        ]
        self.coverages: list[int] = [0] * (len(self.alts) + 1)
        self.quality: np.float32 = rec.qual()
        self.filt: str = "PASS"  # reference hardcodes PASS (variant.hpp:91)
        self.info: str = "."
        self.gt_a1 = self.gt_a2 = EMPTY_I32  # set only for the Python extraction
        self.phase = EMPTY_BOOL
        self.frequencies: list[np.float32] = []
        self.computed_gts: list[tuple[str, float]] = []
        self.min_size = self.max_size = 0

        # set_sizes (variant.hpp:108-124)
        self.has_alts = bool(self.alts)
        self.is_present = True
        if self.has_alts:
            mn = mx = self.ref_size
            for a in self.alts:
                la = len(a)
                if la < mn:
                    mn = la
                elif la > mx:
                    mx = la
            self.min_size = mn
            self.max_size = mx
            self._extract_frequencies(rec, freq_key, uniform)

    # -- frequencies (variant.hpp:126-156) --------------------------------
    def _extract_frequencies(self, rec: VcfRecord, freq_key: str, uniform: bool):
        if not uniform:
            vals = rec.info_floats(freq_key)
            freqs: list[np.float32] = [np.float32(0.0)]
            for i in range(len(self.alts)):
                # The reference indexes the INFO array by the *filtered* alt
                # index (variant.hpp:137-141); with symbolic alts dropped the
                # remaining freqs shift down — replicated.  Reading past the
                # provided values is UB upstream; we pad with 0.
                if vals is not None and i < len(vals):
                    freqs.append(np.float32(vals[i]))
                else:
                    freqs.append(np.float32(0.0))
            # accumulate(..., 0.0) runs in double, result stored as float
            s = 0.0
            for f in freqs:
                s += float(f)
            ref_freq = np.float32(1.0 - s)
            if ref_freq < 0:
                ref_freq = np.float32(0.0)
            freqs[0] = ref_freq
            self.frequencies = freqs
        else:
            u = np.float32(1.0) / np.float32(len(self.alts) + 1)
            self.frequencies = [u] * (len(self.alts) + 1)
        if self.frequencies[0] == np.float32(1.0):
            self.is_present = False

    # -- genotypes (variant.hpp:158-211) ----------------------------------
    def _extract_genotypes(self, rec: VcfRecord, selected: list[int]):
        """(a1, a2, phase) over the selected samples, or None where the
        record has no GT data, which clears ``has_alts``."""
        out = rec.genotypes_arrays(selected)
        if out is None:
            self.has_alts = False
            return None
        enc, ploidy = out  # (n, ploidy) integer, htslib encoding
        first = enc[:, 0]
        if ploidy >= 2:
            second = enc[:, 1]
        else:
            # the reference reads slot base+1 anyway, which for ploidy 1 is
            # the NEXT sample's first entry; the final sample's read is out
            # of bounds upstream — defined here as VECTOR_END (copy).
            second = np.empty_like(first)
            second[:-1] = first[1:]
            second[-1] = VECTOR_END
        is_end = second == VECTOR_END
        a1 = np.maximum((first >> 1) - 1, 0)
        a2 = np.where(is_end, a1, np.maximum((second >> 1) - 1, 0))
        phased = np.where(is_end, True, (second & 1).astype(bool))
        return a1.astype(np.int32, copy=False), a2.astype(np.int32, copy=False), phased

    @property
    def genotypes(self) -> list[tuple[int, int]]:
        """Per-individual (allele1, allele2) pairs (compat view)."""
        return list(zip(self.gt_a1.tolist(), self.gt_a2.tolist()))

    @property
    def phasing(self) -> list[bool]:
        return self.phase.tolist()

    @property
    def n_individuals(self) -> int:
        return int(self.gt_a1.shape[0])

    # -- accessors (variant.hpp:216-252) ----------------------------------
    def get_allele(self, i: int) -> bytes:
        return self.ref_sub if i == 0 else self.alts[i - 1]

    def get_allele_index(self, allele: bytes) -> int:
        if self.ref_sub == allele:
            return 0
        for i, a in enumerate(self.alts, start=1):
            if a == allele:
                return i
        return -1

    def set_coverage(self, i: int, cov: int) -> None:
        self.coverages[i] = cov

    def add_genotype(self, geno: str, prob: float) -> None:
        self.computed_gts.append((geno, prob))


def from_columns(cols) -> list:
    """The Variants of a scanned batch (``utils/native.py Columns``),
    made in bulk from its columns, as :class:`Variant` makes them from
    records: no record object, and no per-variant array (the GT arrays,
    which only the Python extraction reads, are left empty)."""
    n = cols.n_vars
    names = cols.names
    blob = cols.al_bytes.tobytes()
    off = cols.al_off.tolist()
    alleles = [blob[a:b] for a, b in zip(off[:-1], off[1:])]
    freqs = list(cols.freq)  # np.float32 scalars, as Variant keeps them
    quals = list(cols.qual)
    ids = cols.id_bytes.decode()
    id_off = cols.id_off.tolist()
    starts = cols.al_start.tolist()
    pos, ref_size = cols.pos.tolist(), cols.ref_size.tolist()
    min_size, max_size = cols.min_size.tolist(), cols.max_size.tolist()
    present, name = cols.present.tolist(), cols.name.tolist()
    new = Variant.__new__
    out = []
    for i in range(n):
        lo, hi = starts[i], starts[i + 1]
        v = new(Variant)
        v.seq_name = names[name[i]]
        v.ref_pos = pos[i]
        v.idx = ids[id_off[i]:id_off[i + 1]]
        v.ref_sub = alleles[lo]
        v.alts = alleles[lo + 1:hi]
        v.ref_size = ref_size[i]
        v.min_size = min_size[i]
        v.max_size = max_size[i]
        v.quality = quals[i]
        v.filt = "PASS"
        v.info = "."
        v.gt_a1 = v.gt_a2 = EMPTY_I32
        v.phase = EMPTY_BOOL
        v.frequencies = freqs[lo:hi]
        v.coverages = [0] * (hi - lo)
        v.computed_gts = []
        v.has_alts = True
        v.is_present = bool(present[i])
        out.append(v)
    return out


def _offsets(lengths, n: int) -> np.ndarray:
    out = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.fromiter(lengths, np.int64, n), out=out[1:])
    return out


def to_columns(blocks: list):
    """The Python path's batch as the record scanner's columns
    (``utils/native.py Columns``): ``blocks`` holds each block's
    variants, their GT sources and the contig its reference comes from.
    The batch keeps both.  An ID's offsets count characters, as
    :func:`from_columns` reads them (the scanner takes ASCII IDs only)."""
    from ..utils.native import Columns

    vs = [v for variants, _, _ in blocks for v in variants]
    n = len(vs)
    blk_name = [contig for _, _, contig in blocks]
    names = list(dict.fromkeys([v.seq_name for v in vs] + blk_name))
    name_at = {name: i for i, name in enumerate(names)}
    alleles = [a for v in vs for a in (v.ref_sub, *v.alts)]
    ids = [v.idx for v in vs]

    def col(attr, dtype):
        return np.fromiter((getattr(v, attr) for v in vs), dtype, n)

    return Columns(
        names, vs, [s for _, srcs, _ in blocks for s in srcs],
        blk_off=_offsets((len(b) for b, _, _ in blocks), len(blocks)), blk_name=blk_name,
        pos=col("ref_pos", np.int64), ref_size=col("ref_size", np.int64),
        min_size=col("min_size", np.int64), max_size=col("max_size", np.int64),
        present=col("is_present", np.uint8), qual=col("quality", np.float32),
        name=np.fromiter((name_at[v.seq_name] for v in vs), np.int32, n),
        al_start=_offsets((1 + len(v.alts) for v in vs), n),
        al_off=_offsets(map(len, alleles), len(alleles)),
        al_bytes=np.frombuffer(b"".join(alleles), dtype=np.uint8),
        freq=np.array([f for v in vs for f in v.frequencies], dtype=np.float32),
        id_off=_offsets(map(len, ids), n), id_bytes="".join(ids).encode())
