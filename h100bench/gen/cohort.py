"""A seeded genome slice and its phased cohort VCF, from a configuration.

The frozen, corrected copy of the repository's ``tools/make_synth_scale.py``
that the benchmark generates its inputs with.  What it changes:

* each alternate allele's frequency follows a neutral spectrum, density
  proportional to 1/AF between 1/N and 1 - 1/N over N haplotypes, and each
  haplotype column carries the allele with that probability (the old
  generator drew genotypes uniformly over the alleles whatever the AF);
* every site has at least one carrier and the AF written is the
  columns' own AC/AN, as the 1000 Genomes release's is;
* the super-population keys (``EUR_AF`` and the others) are each
  population's own share, written to four decimals as the release writes
  them; the populations are a seeded split of the samples;
* all genotypes are phased (``a|b``), as the 1000 Genomes release is;
* the VCF is gzipped, in members compressed side by side.

A configuration with a ``lineages`` key (a viral surveillance panel) draws
its haplotype columns from a lineage tree instead, on a stream of its own
(``_lineage_haplotypes``); the genome, the sites and every byte of a
configuration without the key are drawn as before.

Everything is vectorised and deterministic by seed.
"""

from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8)
CHUNK = 2048  # records whose genotype columns are drawn and written together
LINEAGE_STREAM = 3  # the lineage model's stream (0: genome and sites; 1, 2, 100+: the run's)


@dataclass
class Cohort:
    """The generated deployment: what both the program and the plain
    reference are given."""

    contig: str
    genome: np.ndarray            # (L,) uint8 ASCII bases
    pos0: np.ndarray              # (V,) int64, 0-based, ascending and distinct
    refs: list                    # V bytes
    alts: list                    # V lists of bytes
    ids: list                     # V str
    hap: np.ndarray               # (V, N) uint8: the allele each haplotype column carries
    ploidy: int
    samples: int
    freq_text: list               # V str: the value of the configuration's -f key, as written
    fasta: str
    vcf: str
    lineages: dict | None = None  # a lineage panel's draws (_lineage_haplotypes)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of a run's inputs (seeds of any size)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), stream]))


def freq_key(config: dict) -> str:
    """The INFO key the configuration's ``-f`` flag names (AF by default)."""
    flags = config["flags"]
    return flags[flags.index("-f") + 1] if "-f" in flags else "AF"


def n_records(config: dict) -> int:
    if "records" in config:
        return int(config["records"])
    return int(round(config["length_bp"] / config["bp_per_record"]))


def _fmt4(x: np.ndarray) -> list:
    """Frequencies as the 1000 Genomes release writes its population keys."""
    return [("%.4f" % v).rstrip("0").rstrip(".") or "0" for v in x.tolist()]


def _sites(config: dict, genome: np.ndarray, rng: np.random.Generator):
    """Positions, REF and ALT alleles of every record."""
    L = genome.shape[0]
    V = n_records(config)
    max_indel = int(config["indel_max_len"])
    pos0 = np.sort(rng.choice(L - max_indel - 2, size=V, replace=False) + 1).astype(np.int64)
    kind = rng.random(V)
    snp = kind < config["snp_share"]
    ins = ~snp & (kind < config["snp_share"] + (1 - config["snp_share"]) / 2)
    multi = snp & (rng.random(V) < config["multiallelic_share"])
    lens = np.minimum(rng.geometric(0.5, size=V), max_indel)
    off1 = rng.integers(1, 4, size=V)
    off2 = off1 % 3 + 1
    ins_bases = ALPHA[rng.integers(0, 4, size=(V, max_indel))]
    code = np.searchsorted(ALPHA, genome[pos0])
    refs, alts = [], []
    g = genome.tobytes()
    for i, p in enumerate(pos0.tolist()):
        base = g[p : p + 1]
        if snp[i]:
            a = [bytes(ALPHA[(code[i] + off1[i]) % 4 : (code[i] + off1[i]) % 4 + 1])]
            if multi[i]:
                a.append(bytes(ALPHA[(code[i] + off2[i]) % 4 : (code[i] + off2[i]) % 4 + 1]))
            refs.append(base)
        elif ins[i]:
            refs.append(base)
            a = [base + ins_bases[i, : lens[i]].tobytes()]
        else:
            refs.append(g[p : p + lens[i] + 1])
            a = [base]
        alts.append(a)
    return pos0, refs, alts


def _frequencies(n_alt: np.ndarray, n_hap: int, rng: np.random.Generator):
    """(V, 2) float64 AF of each record's first and second alternate: a
    neutral spectrum, log-uniform between 1/n_hap and 1 - 1/n_hap, the two
    of a site kept below 1 together."""
    V = n_alt.shape[0]
    hi = 1.0 - 1.0 / n_hap
    af = np.exp(rng.uniform(np.log(1.0 / n_hap), np.log(hi), size=(V, 2)))
    af[n_alt < 2, 1] = 0.0
    total = af.sum(axis=1)
    over = total > hi
    af[over] *= (hi / total[over])[:, None]
    return af


def _haplotypes(af: np.ndarray, n_hap: int, rng: np.random.Generator) -> np.ndarray:
    """(V, n_hap) uint8 allele of each haplotype column, drawn from AF,
    with a carrier put into a random column where a drawn allele has none."""
    V = af.shape[0]
    hap = np.empty((V, n_hap), dtype=np.uint8)
    for lo in range(0, V, CHUNK):
        a = af[lo : lo + CHUNK].astype(np.float32)
        u = rng.random((a.shape[0], n_hap), dtype=np.float32)
        h = (u < a[:, :1]).astype(np.uint8)
        h[(u >= a[:, :1]) & (u < a[:, :1] + a[:, 1:])] = 2
        hap[lo : lo + CHUNK] = h
    for allele in (1, 2):
        want = af[:, allele - 1] > 0
        none = np.flatnonzero(want & ~(hap == allele).any(axis=1))
        cols = rng.integers(0, n_hap, size=none.shape[0])
        hap[none, cols] = allele
    return hap


def _lineage_haplotypes(lin: dict, n_alt: np.ndarray, n_hap: int,
                        rng: np.random.Generator) -> tuple:
    """((V, n_hap) uint8 allele of each haplotype column, the draws) of a
    panel whose genomes descend from a tree of lineages, as a surveillance
    panel's do:

    * ``n_lineages`` lineages, each after the root attached to a uniformly
      drawn earlier one (a random recursive tree);
    * each lineage defines Poisson(``defining_per_lineage``) sites, and a
      genome carries every site on its lineage's path to the root;
    * every lineage holds one genome, and the rest go to the lineages by
      Zipf(``zipf_s``) over a seeded order of them;
    * the sites left, up to the record count, are private: each is carried
      by a clade of 1 + Geometric(``private_clade_p``) failures genomes, the
      next ones in its lineage from a uniformly drawn genome;
    * a site with a second alternate (``_sites``' multiallelic share; they
      are among the private ones while any are left) carries it on a
      lineage branch disjoint from the first alternate's carriers.

    The draws (``Cohort.lineages``): each lineage's ``parent`` (-1 at the
    root), each column's lineage (``lineage_of``), the ``defining`` rows with
    their lineage (``site_lineage``), the ``private`` rows with the genome
    each clade starts at (``anchor``) and its size (``clade``), and the
    columns of each second alternate (``second``, by row)."""
    V = n_alt.shape[0]
    n_lin = int(lin["n_lineages"])
    if n_hap < n_lin:
        raise ValueError(f"{n_hap} genomes cannot hold {n_lin} lineages")
    parent = rng.integers(0, np.arange(1, n_lin))
    anc = np.zeros((n_lin, n_lin), dtype=bool)  # anc[m, l]: l on m's path to the root
    for m in range(n_lin):
        if m:
            anc[m] = anc[parent[m - 1]]
        anc[m, m] = True
    w = 1.0 / (rng.permutation(n_lin) + 1.0) ** float(lin["zipf_s"])
    counts = 1 + rng.multinomial(n_hap - n_lin, w / w.sum())
    lin_of = rng.permutation(np.repeat(np.arange(n_lin), counts))
    carries = anc[lin_of]  # (n_hap, n_lin): the column carries lineage l's sites
    site_lin = np.repeat(np.arange(n_lin), rng.poisson(float(lin["defining_per_lineage"]),
                                                       size=n_lin))[:V]
    order = rng.permutation(V)
    order = order[np.argsort(n_alt[order] > 1, kind="stable")]
    defining, private = order[: site_lin.shape[0]], order[site_lin.shape[0]:]

    hap = np.zeros((V, n_hap), dtype=np.uint8)
    for lo in range(0, defining.shape[0], CHUNK):
        hap[defining[lo : lo + CHUNK]] = carries[:, site_lin[lo : lo + CHUNK]].T
    members = np.argsort(lin_of, kind="stable")  # the columns, lineage after lineage
    at = np.empty(n_hap, dtype=np.int64)
    at[members] = np.arange(n_hap)
    anchor = rng.integers(0, n_hap, size=private.shape[0])
    size = np.minimum(rng.geometric(float(lin["private_clade_p"]), size=private.shape[0]),
                      np.cumsum(counts)[lin_of[anchor]] - at[anchor])
    first = np.repeat(np.cumsum(size) - size, size)
    hap[np.repeat(private, size),
        members[np.repeat(at[anchor], size) + np.arange(size.sum()) - first]] = 1
    second = {}
    for v in np.flatnonzero(n_alt > 1).tolist():
        ones = hap[v] == 1
        free = np.flatnonzero(~anc[np.unique(lin_of[ones])].any(axis=0))
        if not free.shape[0]:
            raise ValueError(f"record {v}: no lineage branch is apart from its first alternate")
        second[v] = np.flatnonzero(carries[:, rng.choice(free)])
        hap[v, second[v]] = 2
    return hap, {"parent": np.concatenate([[-1], parent]), "lineage_of": lin_of,
                 "defining": defining, "site_lineage": site_lin, "private": private,
                 "anchor": anchor, "clade": size, "second": second}


def _gzip_members(chunks: list) -> list:
    """gzip members compressed side by side (a multi-member gzip file)."""
    def one(b: bytes) -> bytes:
        c = zlib.compressobj(1, zlib.DEFLATED, 31)
        return c.compress(b) + c.flush()

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(one, chunks))


def make_cohort(config: dict, seed: int, out_dir: str) -> Cohort:
    """Write ``<contig>.fa`` and ``cohort.vcf.gz`` into ``out_dir``."""
    rng = rng_for(seed, 0)
    L = int(config["length_bp"])
    contig = config["contig"]
    genome = ALPHA[rng.integers(0, 4, size=L)]
    pos0, refs, alts = _sites(config, genome, rng)
    V = pos0.shape[0]
    ploidy, S = int(config["ploidy"]), int(config["samples"])
    n_hap = ploidy * S
    n_alt = np.array([len(a) for a in alts])
    if "lineages" in config:
        hap, lineages = _lineage_haplotypes(config["lineages"], n_alt, n_hap,
                                            rng_for(seed, LINEAGE_STREAM))
    else:
        lineages = None
        hap = _haplotypes(_frequencies(n_alt, n_hap, rng), n_hap, rng)

    # (key, (V, 2) frequencies) in the order the INFO field gives them
    ac = np.stack([(hap == 1).sum(axis=1), (hap == 2).sum(axis=1)], axis=1)
    info_keys = [("AF", ac / n_hap)]
    pop_of = rng.permutation(np.repeat(np.arange(len(config["populations"])),
                                       list(config["populations"].values())))
    for p, name in enumerate(config["populations"]):
        cols = np.flatnonzero(np.repeat(pop_of == p, ploidy))
        sub = hap[:, cols]
        info_keys.append((f"{name}_AF", np.stack([(sub == 1).sum(axis=1),
                                                  (sub == 2).sum(axis=1)], axis=1)
                          / cols.shape[0]))

    texts = {}
    for key, f in info_keys:
        fmt = (lambda x: ["%.6g" % v for v in x.tolist()]) if key == "AF" else _fmt4
        a, b = fmt(f[:, 0]), fmt(f[:, 1])
        texts[key] = [a[i] if n_alt[i] == 1 else f"{a[i]},{b[i]}" for i in range(V)]
    freq_text = texts[freq_key(config)]
    ids = [f"rs{i + 1}" for i in range(V)]

    fasta = os.path.join(out_dir, f"{contig}.fa")
    with open(fasta, "wb") as f:
        f.write(f">{contig}\n".encode())
        f.write(b"\n".join(genome[i : i + 60].tobytes() for i in range(0, L, 60)) + b"\n")

    head = ["##fileformat=VCFv4.1", f"##contig=<ID={contig},length={L}>"]
    for key, _ in info_keys:
        head.append(f'##INFO=<ID={key},Number=A,Type=Float,Description="Allele frequency">')
    head.append('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">')
    names = [f"S{i:05d}" for i in range(S)]
    head.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" + "\t".join(names))
    chunks = ["\n".join(head).encode() + b"\n"]
    for lo in range(0, V, CHUNK):
        hi = min(lo + CHUNK, V)
        cols = np.empty((hi - lo, S, 2 * ploidy), dtype=np.uint8)
        cols[:, :, 0] = ord("\t")
        h = hap[lo:hi].reshape(hi - lo, S, ploidy) + ord("0")
        cols[:, :, 1] = h[:, :, 0]
        if ploidy == 2:
            cols[:, :, 2] = ord("|")
            cols[:, :, 3] = h[:, :, 1]
        rows = cols.reshape(hi - lo, -1)
        lines = []
        for i in range(lo, hi):
            info = ";".join(
                [f"AC={ac[i, 0]}" + (f",{ac[i, 1]}" if n_alt[i] > 1 else ""),
                 f"AN={n_hap}", f"NS={S}"]
                + [f"{key}={texts[key][i]}" for key, _ in info_keys])
            fixed = (f"{contig}\t{pos0[i] + 1}\t{ids[i]}\t{refs[i].decode()}\t"
                     f"{b','.join(alts[i]).decode()}\t100\tPASS\t{info}\tGT").encode()
            lines.append(fixed + rows[i - lo].tobytes())
        chunks.append(b"\n".join(lines) + b"\n")
    vcf = os.path.join(out_dir, "cohort.vcf.gz")
    with open(vcf, "wb") as f:
        for m in _gzip_members(chunks):
            f.write(m)
    return Cohort(contig=contig, genome=genome, pos0=pos0, refs=refs, alts=alts, ids=ids,
                  hap=hap, ploidy=ploidy, samples=S, freq_text=freq_text, fasta=fasta, vcf=vcf,
                  lineages=lineages)

