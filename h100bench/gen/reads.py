"""A donor's reads: haplotypes of the cohort, sequenced with errors.

The frozen, corrected copy of the repository's ``tools/make_reads.py``
(its vectorised fixed-width FASTQ writer).  What it changes: the reads
come from a donor, whose haplotypes are columns of the cohort (so they
carry its alternate alleles), and not from the reference alone; reads are
drawn from either strand; each base is replaced, with the workload's
error rate, by one of the three others at random; the file is gzipped.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .cohort import ALPHA, Cohort, _gzip_members

COMPLEMENT = np.zeros(256, dtype=np.uint8)
COMPLEMENT[ALPHA] = np.frombuffer(b"TGCA", dtype=np.uint8)
READS_A_MEMBER = 1 << 16


@dataclass
class ReadSet:
    path: str
    reads: np.ndarray   # (n, read_len) uint8 ASCII, in file order
    columns: tuple      # the cohort's haplotype columns the donor carries


def haplotype(cohort: Cohort, col: int) -> np.ndarray:
    """The sequence of one haplotype column: the genome with the column's
    alternate alleles put in, left to right; an allele whose REF span
    starts inside one already put in is left out."""
    g = cohort.genome
    pieces, at = [], 0
    for v in np.flatnonzero(cohort.hap[:, col]).tolist():
        p = int(cohort.pos0[v])
        if p < at:
            continue
        pieces += [g[at:p], np.frombuffer(cohort.alts[v][cohort.hap[v, col] - 1], np.uint8)]
        at = p + len(cohort.refs[v])
    pieces.append(g[at:])
    return np.concatenate(pieces)


def sequence(haps: list, n_reads: int, read_len: int, error_rate: float,
             rng: np.random.Generator) -> np.ndarray:
    """(n_reads, read_len) reads spread evenly over the haplotypes."""
    per = np.full(len(haps), n_reads // len(haps))
    per[: n_reads % len(haps)] += 1
    parts = []
    for h, n in zip(haps, per.tolist()):
        starts = rng.integers(0, h.shape[0] - read_len + 1, size=n)
        parts.append(h[starts[:, None] + np.arange(read_len)])
    seqs = np.concatenate(parts)[rng.permutation(n_reads)]
    flip = rng.random(n_reads) < 0.5
    seqs[flip] = COMPLEMENT[seqs[flip][:, ::-1]]
    err = rng.random(seqs.shape, dtype=np.float32) < error_rate
    codes = np.searchsorted(ALPHA, seqs[err])
    seqs[err] = ALPHA[(codes + rng.integers(1, 4, size=codes.shape[0])) % 4]
    return seqs


def fastq_bytes(seqs: np.ndarray, first: int) -> bytes:
    """Fixed-width FASTQ records ``@rNNNNNNNNN``, quality ``F`` throughout."""
    n, rl = seqs.shape
    head_w = 12
    rec = np.empty((n, head_w + 2 * rl + 4), dtype=np.uint8)
    rec[:, :head_w] = np.frombuffer(b"".join(b"@r%09d\n" % i for i in range(first, first + n)),
                                    dtype=np.uint8).reshape(n, head_w)
    rec[:, head_w : head_w + rl] = seqs
    rec[:, head_w + rl : head_w + rl + 3] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, head_w + rl + 3 : -1] = ord("F")
    rec[:, -1] = ord("\n")
    return rec.tobytes()


def make_donor(cohort: Cohort, columns: tuple, workload: dict, rng: np.random.Generator,
               path: str) -> ReadSet:
    """Sequence the donor whose haplotypes are ``columns`` at the
    workload's depth and write ``path`` (gzipped FASTQ)."""
    rl = int(workload["read_length"])
    n_reads = int(round(workload["depth"] * cohort.genome.shape[0] / rl))
    seqs = sequence([haplotype(cohort, c) for c in columns], n_reads, rl,
                    float(workload["error_rate"]), rng)
    chunks = [fastq_bytes(seqs[lo : lo + READS_A_MEMBER], lo)
              for lo in range(0, n_reads, READS_A_MEMBER)]
    with open(path, "wb") as f:
        for m in _gzip_members(chunks):
            f.write(m)
    return ReadSet(path=path, reads=seqs, columns=tuple(columns))


def pick_donors(cohort: Cohort, n: int, rng: np.random.Generator) -> list:
    """``n`` donors, each ``ploidy`` distinct haplotype columns."""
    n_hap = cohort.hap.shape[1]
    return [tuple(sorted(rng.choice(n_hap, size=cohort.ploidy, replace=False).tolist()))
            for _ in range(n)]


def k3_windows(reads: np.ndarray, ref_k: int) -> int:
    """Windows the counter's K3 scans for a read set: the reads joined by
    one separator byte each, less ``ref_k - 1``."""
    n, rl = reads.shape
    return n * (rl + 1) - ref_k + 1 if rl >= ref_k else 0
