"""The plain reference: MALVA's index, count, call step and genotyping,
in NumPy and Python, from the generator's arrays.

It follows the published genotyper (MALVA, var_block.hpp, main.cpp,
bloom_filter.hpp, kmap.hpp; a description is in SURVEY.md) and works
every structure out again from the inputs the benchmark made: the
genome, the records with their allele frequencies as written, the
haplotype columns and the donors' reads.  It imports nothing of the
program, and it takes nothing the program made; the program's index file
and VCFs are only read to be judged (``check.py``).

What it does, in the order the genotyper does it:

1. Blocks: records in order; a record joins the block when it is near
   the last one (``near``).  The index's pass leaves out the records
   whose reference-allele frequency is 1 ("absent"); the call's keeps
   them in the blocks, and they get no signatures.
2. Signatures: for each present record at least k from either end, the
   combinations of nearby, non-overlapping present records grown to the
   left and to the right (``grow``), and for each combination the
   distinct allele strings the cohort's haplotypes carry over it; each is
   rendered into a k-mer centred on the record's allele, padded or cut
   with the genome.
3. Index: the reference allele's k-mers are the exact map's keys; the
   alternate alleles' k-mers set bits of the alternate filter; every
   43-mer of the genome whose centre 35-mer's bit is set there sets its
   own bit in the context filter.  A bit is the XXH3 of the canonical
   k-mer modulo the filter's size.
4. Count: the canonical 43-mers of the reads (pure ACGT windows), those
   seen at least twice, counts capped at 255.
5. Call step: each counted context adds its count to the map value of
   its canonical centre, where that is a key, and, unless the context's
   own bit is set in the context filter, to the counter of the centre's
   bit in the alternate filter, where that bit is set (read mod 2^16).
6. Pass 2: each allele's coverage is the largest, over its signatures,
   of the integer running mean of its k-mers' nonzero weights; then the
   genotype likelihoods (float32 terms, double sums, as the C++ computes
   them) and one VCF line a record.

The control (``Reference.state(..., cap=CONTROL_CAP)``) counts in the
precision below the counter's: four bits, counts capped at 15, where the
configuration's counter (KMC's) keeps eight and caps them at 255.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np

from .xxh3 import xxh3_64

CODE = np.full(256, 255, dtype=np.uint8)
CODE[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = np.zeros(256, dtype=np.uint8)
COMP[BASES] = np.frombuffer(b"TGCA", dtype=np.uint8)
CI, CS = 2, 255           # the counter's least count and its cap (KMC's defaults)
CONTROL_CAP = 15          # the control's cap: counts held in four bits


# --- records and blocks -------------------------------------------------

@dataclass
class Record:
    pos: int                  # 0-based
    ref: bytes
    alts: list
    ident: str
    freqs: list               # float32 per allele, the reference's first
    present: bool
    row: int                  # the record's row of the haplotype matrix
    min_size: int = 0

    def __post_init__(self):
        self.min_size = min([len(self.ref)] + [len(a) for a in self.alts])

    def allele(self, i: int) -> bytes:
        return self.ref if i == 0 or i > len(self.alts) else self.alts[i - 1]

    def allele_index(self, s: bytes) -> int:
        for i, a in enumerate([self.ref] + self.alts):
            if a == s:
                return i
        return -1


def records(cohort) -> list:
    """The cohort's records as the genotyper reads them, with the
    frequencies of the configuration's key parsed to float32."""
    out = []
    for i in range(cohort.pos0.shape[0]):
        vals = [np.float32(t) for t in cohort.freq_text[i].split(",")]
        freqs = [np.float32(0.0)] + [vals[j] if j < len(vals) else np.float32(0.0)
                                     for j in range(len(cohort.alts[i]))]
        s = 0.0
        for f in freqs:
            s += float(f)
        ref_f = np.float32(1.0 - s)
        freqs[0] = ref_f if ref_f >= 0 else np.float32(0.0)
        out.append(Record(pos=int(cohort.pos0[i]), ref=cohort.refs[i],
                          alts=list(cohort.alts[i]), ident=cohort.ids[i], freqs=freqs,
                          present=freqs[0] != np.float32(1.0), row=i))
    return out


def overlapping(a: Record, b: Record) -> bool:
    return a.pos <= b.pos < a.pos + len(a.ref)


def near(a: Record, b: Record, k: int, extra: int = 0) -> bool:
    return a.pos + len(a.ref) - a.min_size - 1 + extra + (k + 1) // 2 >= b.pos


def blocks(recs: list, k: int, keep_absent: bool):
    block: list = []
    for r in recs:
        if not keep_absent and not r.present:
            continue
        if block and not near(block[-1], r, k):
            yield block
            block = []
        block.append(r)
    if block:
        yield block


def grow(block: list, i: int, step: int, k: int, slack: int) -> list:
    """Combinations of present records to one side of ``block[i]``, each
    a list of block indices going outward (var_block.hpp:436-624).

    A record joins a combination only while it is near the middle one, and
    nearness reaches at most the combinations' largest sum of lengths
    lost, plus ``slack`` (the block's largest REF length less shortest
    allele) on the left, past it; records are in position order, so the
    walk stops there: beyond it a record changes no combination."""
    mid = block[i]
    combs, sums = [], []
    js = range(i + 1, len(block)) if step > 0 else range(i - 1, -1, -1)
    right_reach = mid.pos + len(mid.ref) - mid.min_size - 1 + (k + 1) // 2

    def ov(last, cur):  # the earlier of the two first
        return overlapping(last, cur) if step > 0 else overlapping(cur, last)

    def close(cur, extra):
        return near(mid, cur, k, extra) if step > 0 else near(cur, mid, k, extra)

    for j in js:
        cur = block[j]
        most = max(sums, default=0)
        if (cur.pos > right_reach + most if step > 0
                else cur.pos + slack - 1 + most + (k + 1) // 2 < mid.pos):
            break
        if not cur.present or (overlapping(mid, cur) if step > 0 else overlapping(cur, mid)):
            continue
        grown = len(cur.ref) - cur.min_size
        if not combs:
            if close(cur, 0):
                combs.append([j])
                sums.append(grown)
            continue
        fits = False
        for c in range(len(combs)):
            if not ov(block[combs[c][-1]], cur):
                fits = True
                if close(cur, sums[c]):
                    combs[c].append(j)
                    sums[c] += grown
        if fits:
            continue
        more, more_sums = [], []
        for c in range(len(combs)):
            comb, s = list(combs[c]), sums[c]
            while comb and ov(block[comb[-1]], cur):
                gone = block[comb.pop()]
                s -= len(gone.ref) - gone.min_size
            comb.append(j)
            if close(cur, s):
                fits = True
                more.append(comb)
                more_sums.append(s + grown)
        combs += more
        sums += more_sums
        if not fits:
            break
    return combs


def combinations(block: list, i: int, k: int, slack: int) -> list:
    left, right = grow(block, i, -1, k, slack), grow(block, i, +1, k, slack)
    if not left and not right:
        return [[i]]
    if not left:
        return [[i] + r for r in right]
    return [l[::-1] + [i] + r for l in left for r in (right or [[]])]


def allele_strings(block: list, comb: list, hap: np.ndarray) -> set:
    """The distinct tuples of allele strings the haplotype columns carry
    over the records of ``comb``."""
    rows = hap[[block[j].row for j in comb]]
    if len(comb) <= 32:
        shift = np.arange(len(comb), dtype=np.uint64) * np.uint64(2)
        key = np.bitwise_or.reduce(rows.astype(np.uint64) << shift[:, None], axis=0)
        uniq = np.unique(key)
        digits = ((uniq[:, None] >> shift[None, :]) & np.uint64(3)).tolist()
    else:
        digits = np.unique(rows.T, axis=0).tolist()
    alleles = [[block[j].allele(a) for a in range(4)] for j in comb]
    return {tuple(alleles[t][d] for t, d in enumerate(row)) for row in digits}


def render(block: list, i: int, comb: list, strings: set, genome: bytes, k: int, out: dict):
    """Signatures of record ``block[i]`` for one combination, by allele."""
    subs, end = [], -1
    for j in comb:
        r = block[j]
        if end != -1:
            subs.append(genome[end : r.pos])
        end = r.pos + len(r.ref)
    for aac in strings:
        if len(aac) == 1 and len(aac[0]) >= k:
            mid = aac[0]
            sig = [mid[p : p + k] for p in range(len(mid) - k + 1)]
        else:
            s, at, mid = b"", 0, b""
            for t, a in enumerate(aac):
                if comb[t] == i:
                    at, mid = len(s), a
                s += a + (subs[t] if t < len(subs) else b"")
            first = at + len(mid) // 2
            pre, post = k // 2 - first, (k + 1) // 2 - (len(s) - first)
            if pre >= 0:
                p0 = block[comb[0]].pos
                s = genome[max(p0 - pre, 0) : p0] + s
            else:
                s = s[-pre:]
            if post >= 0:
                last = block[comb[-1]]
                e = last.pos + len(last.ref)
                s = s + genome[e : e + post]
            else:
                s = s[: len(s) + post]
            sig = [s]
        out.setdefault(block[i].allele_index(mid), []).append(sig)


def signatures(recs: list, genome: bytes, hap: np.ndarray, k: int, keep_absent: bool,
               memo: dict | None = None) -> dict:
    """{record row: {allele index: [signature, ...]}} of every record that
    has signatures, a signature being a list of k-mer strings.  A record's
    signatures depend only on its block, so ``memo`` (block rows -> the
    block's signatures) lets the index's pass and the call's share the
    blocks they have in common."""
    out = {}
    L = len(genome)
    memo = {} if memo is None else memo
    for block in blocks(recs, k, keep_absent):
        key = tuple(r.row for r in block)
        if key not in memo:
            memo[key] = _block_signatures(block, genome, hap, k, L)
        out.update(memo[key])
    return out


def _block_signatures(block: list, genome: bytes, hap: np.ndarray, k: int, L: int) -> dict:
    out = {}
    slack = max(len(r.ref) - r.min_size for r in block)
    for i, r in enumerate(block):
        if not r.present or r.pos < k or r.pos > L - k:
            continue
        sigs: dict = {}
        for comb in combinations(block, i, k, slack):
            render(block, i, comb, allele_strings(block, comb, hap), genome, k, sigs)
        out[r.row] = sigs
    return out


# --- k-mers -------------------------------------------------------------

def canonical(rows: np.ndarray) -> np.ndarray:
    """Each row or its reverse complement, whichever is less as a string
    (the reverse complement on a tie, which is then the same bytes)."""
    rc = COMP[rows[:, ::-1]]
    diff = rows != rc
    first = np.argmax(diff, axis=1)
    n = np.arange(rows.shape[0])
    fwd = diff[n, first] & (rows[n, first] < rc[n, first])
    return np.where(fwd[:, None], rows, rc)


def as_rows(kmers: list, k: int) -> np.ndarray:
    bad = [len(s) for s in kmers if len(s) != k]
    if bad:
        raise ValueError(f"k-mers of {sorted(set(bad))} bases where {k} were expected")
    if not kmers:
        return np.zeros((0, k), dtype=np.uint8)
    return np.frombuffer(b"".join(kmers), dtype=np.uint8).reshape(-1, k)


def bits(rows: np.ndarray, size: int) -> np.ndarray:
    """Filter bit of each row: XXH3 of its canonical form mod ``size``."""
    if rows.shape[0] == 0:
        return np.zeros(0, dtype=np.uint64)
    return xxh3_64(canonical(rows)) % np.uint64(size)


def key_view(rows: np.ndarray) -> np.ndarray:
    rows = np.ascontiguousarray(rows)
    return rows.view(f"V{rows.shape[1]}").ravel()


def member(sorted_keys: np.ndarray, probe: np.ndarray) -> tuple:
    """(found, position) of each probe in a sorted array."""
    if sorted_keys.shape[0] == 0:
        return np.zeros(probe.shape[0], dtype=bool), np.zeros(probe.shape[0], dtype=np.int64)
    at = np.searchsorted(sorted_keys, probe)
    at_c = np.minimum(at, sorted_keys.shape[0] - 1)
    return sorted_keys[at_c] == probe, at_c


# --- the index ----------------------------------------------------------

@dataclass
class Index:
    size: int                 # bits of each filter
    alt_bits: np.ndarray      # sorted distinct set bits of the alternate filter
    ctx_bits: np.ndarray      # sorted distinct set bits of the context filter
    map_keys: np.ndarray      # sorted canonical 35-mers (void rows) of the exact map


def build_index(genome: np.ndarray, sigs: dict, recs: list, size: int, k: int,
                ref_k: int) -> Index:
    ref_kmers, alt_kmers = [], []
    for row, by_allele in sigs.items():
        for allele, sig_list in by_allele.items():
            dst = ref_kmers if allele == 0 else alt_kmers
            for sig in sig_list:
                dst += [s for s in sig if s]
    alt_bits = np.unique(bits(as_rows(alt_kmers, k), size))
    map_keys = np.unique(key_view(canonical(as_rows(ref_kmers, k))))
    ctx = []
    off = (ref_k - k) // 2
    n_pos = genome.shape[0] - ref_k + 1
    for lo in range(0, n_pos, 1 << 20):
        win = np.lib.stride_tricks.sliding_window_view(
            genome[lo : min(lo + (1 << 20), n_pos) + ref_k - 1], ref_k)
        hit, _ = member(alt_bits, bits(np.ascontiguousarray(win[:, off : off + k]), size))
        if hit.any():
            ctx.append(bits(np.ascontiguousarray(win[hit]), size))
    ctx_bits = np.unique(np.concatenate(ctx)) if ctx else np.zeros(0, dtype=np.uint64)
    return Index(size=size, alt_bits=alt_bits, ctx_bits=ctx_bits, map_keys=map_keys)


# --- counting and the call step -----------------------------------------

def count(reads: np.ndarray, ref_k: int, cap: int = CS) -> tuple:
    """(contexts (M, ref_k) uint8 canonical, counts int64) of the reads:
    pure-ACGT windows, seen at least CI times, counts capped at ``cap``."""
    code = CODE[reads]
    if (code == 255).any():
        raise ValueError("reads with bases other than ACGT are not written for here")
    n, rl = code.shape
    nw = rl - ref_k + 1
    code = code.astype(np.uint64)
    n_hi = ref_k - 32      # bases in the high word; the low word holds 32
    hi = np.zeros((n, nw), dtype=np.uint64)
    lo = np.zeros((n, nw), dtype=np.uint64)
    rhi = np.zeros((n, nw), dtype=np.uint64)
    rlo = np.zeros((n, nw), dtype=np.uint64)
    for j in range(ref_k):
        c = code[:, j : j + nw]
        r = np.uint64(3) - code[:, ref_k - 1 - j : ref_k - 1 - j + nw]
        if j < n_hi:
            sh = np.uint64(2 * (n_hi - 1 - j))
            hi |= c << sh
            rhi |= r << sh
        else:
            sh = np.uint64(2 * (ref_k - 1 - j))
            lo |= c << sh
            rlo |= r << sh
    fwd = (hi < rhi) | ((hi == rhi) & (lo < rlo))
    khi = np.where(fwd, hi, rhi).ravel()
    klo = np.where(fwd, lo, rlo).ravel()
    del hi, lo, rhi, rlo, fwd
    order = np.lexsort((klo, khi))
    khi, klo = khi[order], klo[order]
    start = np.flatnonzero(np.concatenate([[True], (khi[1:] != khi[:-1]) | (klo[1:] != klo[:-1])]))
    counts = np.diff(np.append(start, khi.shape[0]))
    keep = counts >= CI
    khi, klo, counts = khi[start[keep]], klo[start[keep]], np.minimum(counts[keep], cap)
    ctx = np.empty((khi.shape[0], ref_k), dtype=np.uint8)
    for j in range(ref_k):
        word, sh = (khi, 2 * (n_hi - 1 - j)) if j < n_hi else (klo, 2 * (ref_k - 1 - j))
        ctx[:, j] = BASES[(word >> np.uint64(sh)) & np.uint64(3)]
    return ctx, counts.astype(np.int64)


@dataclass
class State:
    """The counters after a sample's call step."""

    map_vals: np.ndarray      # int64 per map key
    alt_counts: np.ndarray    # int64 per set bit of the alternate filter


def call_step(index: Index, contexts: np.ndarray, counts: np.ndarray, k: int,
              ref_k: int) -> State:
    off = (ref_k - k) // 2
    centres = canonical(np.ascontiguousarray(contexts[:, off : off + k]))
    map_vals = np.zeros(index.map_keys.shape[0], dtype=np.int64)
    found, at = member(index.map_keys, key_view(centres))
    np.add.at(map_vals, at[found], counts[found])
    known, _ = member(index.ctx_bits, bits(contexts, index.size))
    set_, rank = member(index.alt_bits, bits(centres, index.size))
    take = set_ & ~known
    alt_counts = np.zeros(index.alt_bits.shape[0], dtype=np.int64)
    np.add.at(alt_counts, rank[take], counts[take])
    return State(map_vals=map_vals, alt_counts=alt_counts)


# --- pass 2 -------------------------------------------------------------

def sig_kmers(recs: list, call_sigs: dict) -> tuple:
    """The call pass's k-mers in the order coverage reads them (record,
    allele, signature, k-mer; empty strings left out), and whether each is
    a reference allele's."""
    kmers, is_ref = [], []
    for r in recs:
        for allele, sig_list in call_sigs.get(r.row, {}).items():
            for sig in sig_list:
                for s in sig:
                    if s:
                        kmers.append(s)
                        is_ref.append(allele == 0)
    return kmers, np.array(is_ref, dtype=bool)


@dataclass
class Lookups:
    """Where each of the call pass's k-mers is looked up: the exact map's
    slot of a reference allele's k-mer, the alternate filter's counter of
    another's (``found`` False where there is none)."""

    is_ref: np.ndarray
    found: np.ndarray
    at: np.ndarray

    @classmethod
    def of(cls, index: Index, recs: list, call_sigs: dict, k: int) -> "Lookups":
        kmers, is_ref = sig_kmers(recs, call_sigs)
        rows = as_rows(kmers, k)
        found = np.zeros(rows.shape[0], dtype=bool)
        at = np.zeros(rows.shape[0], dtype=np.int64)
        found[is_ref], at[is_ref] = member(index.map_keys, key_view(canonical(rows[is_ref])))
        found[~is_ref], at[~is_ref] = member(index.alt_bits, bits(rows[~is_ref], index.size))
        return cls(is_ref=is_ref, found=found, at=at)

    def weights(self, state: State) -> list:
        """Each k-mer's weight: its map value, read as a signed 32-bit int,
        or its counter mod 2^16; 0 where it is not found."""
        m = state.map_vals[np.where(self.is_ref, self.at, 0)] & 0xFFFFFFFF
        m = np.where(m >= 1 << 31, m - (1 << 32), m)
        a = state.alt_counts[np.where(self.is_ref, 0, self.at)] & 0xFFFF if \
            state.alt_counts.shape[0] else np.zeros_like(m)
        return np.where(self.found, np.where(self.is_ref, m, a), 0).tolist()


def coverages(rec: Record, by_allele: dict, w: list, at: int) -> tuple:
    """(coverage of each allele, position after the record's k-mers in
    ``w``): per allele the largest, over its signatures, integer running
    mean of the nonzero weights (main.cpp:151-184)."""
    cov = [0] * (len(rec.alts) + 1)
    for allele, sig_list in by_allele.items():
        best = 0
        for sig in sig_list:
            cur = n = 0
            for s in sig:
                if not s:
                    continue
                x = w[at]
                at += 1
                if x > 0:
                    cur = (cur * n + x) // (n + 1)
                    n += 1
            best = max(best, cur)
        if allele >= 0:
            cov[allele] = best
    return cov, at


def _libm_logf():
    try:
        fn = ctypes.CDLL("libm.so.6").logf
    except OSError:
        return None
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return fn


_LOGF = _libm_logf()


def logf(x) -> np.float32:
    """C's logf of a float32 operand, which the genotyper's C++ calls."""
    x = np.float32(x)
    if x == 0:
        return np.float32(-math.inf)
    if x < 0:
        return np.float32(math.nan)
    return np.float32(_LOGF(float(x))) if _LOGF is not None else np.float32(math.log(float(x)))


def log_binomial(n: int, k: int) -> float:
    """ln C(n, k) in Stirling's form, as the genotyper computes it."""
    if n == 0 or n == k or k == 0:
        return 0.0
    return n * math.log(n) - k * math.log(k) - (n - k) * math.log(n - k)


def genotype(rec: Record, cov: list, haploid: bool, max_cov: int, err: np.float32) -> list:
    """[(genotype, probability), ...] of one record (var_block.hpp:224-330):
    float32 terms (C's logf of float32 operands), double sums."""
    best = "0" if haploid else "0/0"
    over = [(best, 0.0) for c in cov if c > max_cov]
    if over:
        return over
    total = sum(cov)
    if total == 0:
        return [(best, 0.0)]
    n_all = len(cov)
    f32 = np.float32
    l1 = logf(f32(1) - err)
    l2 = logf(err / f32(n_all - 1))
    out = []

    def prob(lp: float) -> float:
        return 0.0 if math.isinf(lp) else math.exp(lp)

    if haploid:
        for g in range(n_all):
            error = total - cov[g]
            post = (log_binomial(cov[g] + error, cov[g]) + float(f32(cov[g]) * l1)
                    + float(f32(error) * l2))
            out.append((str(g), prob(float(f32(2) * logf(rec.freqs[g])) + post)))
        return out
    lh = logf((f32(1) - err) / f32(2))
    le = logf(err / f32(n_all - 2)) if n_all > 2 else f32(0)
    for g1 in range(n_all):
        for g2 in range(g1, n_all):
            if g1 == g2:
                prior = float(f32(2) * logf(rec.freqs[g1]))
                error = total - cov[g1]
                post = (log_binomial(cov[g1] + error, cov[g1]) + float(f32(cov[g1]) * l1)
                        + float(f32(error) * l2))
            else:
                prior = float(logf(f32(2) * rec.freqs[g1] * rec.freqs[g2]))
                t1, t2 = cov[g1], cov[g2]
                error = total - t1 - t2
                post = (log_binomial(t1 + t2 + error, t1 + t2) + log_binomial(t1 + t2, t1)
                        + float(f32(t1) * lh) + float(f32(t2) * lh))
                if n_all > 2:
                    post += float(f32(error) * le)
            out.append((f"{g1}/{g2}", prob(prior + post)))
    return out


def vcf_line(contig: str, rec: Record, cov: list, gts: list, haploid: bool,
             verbose: bool) -> str:
    """The record's output line (var_block.hpp:337-396): with ``verbose``
    the INFO field gives the coverages and each genotype's posterior to
    six decimals, else it is ``.``."""
    best, best_q = ("0" if haploid else "0/0"), 0.0
    total = sum(x for _, x in gts)
    parts = []
    for g, x in gts:
        q = x / total if total != 0 else math.nan
        if q > best_q:
            best, best_q = g, q
        parts.append(f"{g}:" + ("-nan" if math.isnan(q) else f"{q:.6f}"))
    info = f"COVS={','.join(map(str, cov))};GTS={','.join(parts)}" if verbose else "."
    gq = int(math.floor(best_q * 100 + 0.5))
    return (f"{contig}\t{rec.pos + 1}\t{rec.ident}\t{rec.ref.decode()}\t"
            f"{b','.join(rec.alts).decode()}\t100\tPASS\t{info}\tGT:GQ\t{best}:{gq}")


@dataclass
class Reference:
    """Everything of a cohort that no sample changes: the records, the
    index, the call pass's signatures and where their k-mers are looked
    up."""

    contig: str
    recs: list
    index: Index
    call_sigs: dict
    lookups: Lookups
    k: int
    ref_k: int
    haploid: bool
    verbose: bool
    max_cov: int
    err: np.float32

    @classmethod
    def build(cls, cohort, size_bits: int, k: int, ref_k: int, haploid: bool,
              verbose: bool = False, max_cov: int = 200, err: float = 0.001) -> "Reference":
        recs = records(cohort)
        g = cohort.genome.tobytes()
        memo: dict = {}
        call_sigs = signatures(recs, g, cohort.hap, k, True, memo)
        index = build_index(cohort.genome, signatures(recs, g, cohort.hap, k, False, memo),
                            recs, size_bits, k, ref_k)
        return cls(contig=cohort.contig, recs=recs, index=index, call_sigs=call_sigs,
                   lookups=Lookups.of(index, recs, call_sigs, k), k=k, ref_k=ref_k,
                   haploid=haploid, verbose=verbose, max_cov=max_cov, err=np.float32(err))

    def state(self, reads: np.ndarray, cap: int = CS) -> State:
        """The counters after the call step of a read set, its counts
        capped at ``cap`` (the counter's 255; the control's 15, counts
        held in four bits)."""
        contexts, counts = count(reads, self.ref_k, cap)
        return call_step(self.index, contexts, counts, self.k, self.ref_k)

    def vcf(self, state: State) -> list:
        """The VCF's records (no header) of a sample's counters."""
        w, at, lines = self.lookups.weights(state), 0, []
        for r in self.recs:
            cov, at = coverages(r, self.call_sigs.get(r.row, {}), w, at)
            gts = genotype(r, cov, self.haploid, self.max_cov, self.err)
            lines.append(vcf_line(self.contig, r, cov, gts, self.haploid, self.verbose))
        return lines
