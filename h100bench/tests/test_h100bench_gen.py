"""The generators: deterministic by seed, and the shapes the
configurations state."""

import gzip

import numpy as np
import pytest

from h100bench.gen.cohort import make_cohort, n_records, rng_for
from h100bench.gen.reads import haplotype, k3_windows, make_donor, pick_donors


def _cohort(cell, seed, tmp_path):
    cfg, _ = cell
    tmp_path.mkdir(parents=True, exist_ok=True)
    return make_cohort(cfg, seed, str(tmp_path))


def _vcf_lines(path):
    with gzip.open(path, "rt") as f:
        return f.read().splitlines()


@pytest.mark.parametrize("cell", ["chr_cell", "haploid_cell"])
def test_same_seed_same_inputs(cell, request, tmp_path):
    cell = request.getfixturevalue(cell)
    a = _cohort(cell, 2**40 + 3, tmp_path / "a")
    b = _cohort(cell, 2**40 + 3, tmp_path / "b")
    c = _cohort(cell, 2**40 + 4, tmp_path / "c")
    assert _vcf_lines(a.vcf) == _vcf_lines(b.vcf)
    assert np.array_equal(a.genome, b.genome) and not np.array_equal(a.genome, c.genome)
    cols = pick_donors(a, 1, rng_for(9, 1))[0]
    ra = make_donor(a, cols, cell[1], rng_for(9, 2), str(tmp_path / "ra.fq.gz"))
    rb = make_donor(b, cols, cell[1], rng_for(9, 2), str(tmp_path / "rb.fq.gz"))
    assert np.array_equal(ra.reads, rb.reads)
    with gzip.open(ra.path, "rb") as f, gzip.open(rb.path, "rb") as g:
        assert f.read() == g.read()


def test_chr_cohort_shape(chr_cell, tmp_path):
    cfg, _ = chr_cell
    co = _cohort(chr_cell, 11, tmp_path)
    lines = _vcf_lines(co.vcf)
    body = [ln for ln in lines if not ln.startswith("#")]
    assert len(body) == n_records(cfg) == round(cfg["length_bp"] / cfg["bp_per_record"])
    assert lines[[i for i, ln in enumerate(lines) if ln.startswith("#CHROM")][0]].count("\t") \
        == 8 + cfg["samples"]
    assert np.all(np.diff(co.pos0) > 0)
    n_hap = 2 * cfg["samples"]
    for i, ln in enumerate(body[:500]):
        f = ln.split("\t")
        assert int(f[1]) == co.pos0[i] + 1 and f[3].encode() == co.refs[i]
        gts = f[9:]
        assert all(len(g) == 3 and g[1] == "|" for g in gts)
        alleles = np.array([[int(g[0]), int(g[2])] for g in gts]).ravel()
        assert np.array_equal(alleles, co.hap[i])
        info = dict(kv.split("=") for kv in f[7].split(";"))
        ac = [int(x) for x in info["AC"].split(",")]
        assert all(a >= 1 for a in ac)  # every site carried, as in the release
        assert [float(x) for x in info["AF"].split(",")] == pytest.approx([a / n_hap for a in ac],
                                                                         rel=1e-5)
        assert info["EUR_AF"] == co.freq_text[i]
    snp = np.mean([len(r) == 1 and all(len(a) == 1 for a in al)
                   for r, al in zip(co.refs, co.alts)])
    assert abs(snp - cfg["snp_share"]) < 0.03
    # a neutral spectrum: most sites rare, a few common
    af = (co.hap == 1).mean(axis=1)
    assert np.median(af) < 0.1 and (af > 0.5).mean() > 0.01


def test_haploid_cohort_shape(haploid_cell, tmp_path):
    cfg, _ = haploid_cell
    co = _cohort(haploid_cell, 12, tmp_path)
    body = [ln for ln in _vcf_lines(co.vcf) if not ln.startswith("#")]
    assert len(body) == cfg["records"] and co.hap.shape == (cfg["records"], cfg["samples"])
    assert np.all(np.diff(co.pos0) > 0) and co.pos0[-1] < cfg["length_bp"]
    for i, ln in enumerate(body):
        f = ln.split("\t")
        assert len(f) == 9 + cfg["samples"] and f[8] == "GT"
        assert int(f[1]) == co.pos0[i] + 1 and f[3].encode() == co.refs[i]
        # the GT layout is one allele a column: "a\t" and nothing else
        assert ln.split("\t", 9)[9] == "\t".join(chr(48 + a) for a in co.hap[i].tolist())
        info = dict(kv.split("=") for kv in f[7].split(";"))
        ac = [int(x) for x in info["AC"].split(",")]
        assert ac == [int((co.hap[i] == a).sum()) for a in range(1, len(co.alts[i]) + 1)]
        assert min(ac) >= 1 and info["AN"] == str(cfg["samples"])
        assert [float(x) for x in info["AF"].split(",")] == \
            pytest.approx([a / cfg["samples"] for a in ac], rel=1e-5)
    assert (co.hap.max(axis=1) > 0).all()


def _path(parent, lineage):
    path = set()
    while lineage >= 0:
        path.add(int(lineage))
        lineage = parent[lineage]
    return path


@pytest.mark.parametrize("seed", [12, 2**41 + 9])
def test_lineage_columns_are_their_paths_and_clades(haploid_cell, seed, tmp_path):
    """Each column's first alternates are exactly its lineage path's
    defining sites and the private clades it falls in, its second
    alternates exactly those drawn for it, on a branch apart from the
    first's carriers."""
    cfg, _ = haploid_cell
    co = _cohort(haploid_cell, seed, tmp_path)
    lin = co.lineages
    parent, lineage_of = lin["parent"].tolist(), lin["lineage_of"]
    assert parent[0] == -1 and all(0 <= p < m for m, p in enumerate(parent) if m)
    n_lin = cfg["lineages"]["n_lineages"]
    assert np.bincount(lineage_of, minlength=n_lin).min() >= 1
    assert sorted(np.concatenate([lin["defining"], lin["private"]]).tolist()) == \
        list(range(cfg["records"]))
    want = {j: set() for j in range(cfg["samples"])}
    for v, l in zip(lin["defining"].tolist(), lin["site_lineage"].tolist()):
        for j in range(cfg["samples"]):
            if l in _path(parent, lineage_of[j]):
                want[j].add(v)
    for v, a, n in zip(lin["private"].tolist(), lin["anchor"].tolist(), lin["clade"].tolist()):
        same = [j for j in range(cfg["samples"]) if lineage_of[j] == lineage_of[a]]
        assert n >= 1
        for j in same[same.index(a) : same.index(a) + n]:
            want[j].add(v)
    for j in range(cfg["samples"]):
        assert set(np.flatnonzero(co.hap[:, j] == 1).tolist()) == want[j], j
    multi = [v for v in range(cfg["records"]) if len(co.alts[v]) > 1]
    assert multi and sorted(lin["second"]) == multi
    for v in multi:
        assert np.flatnonzero(co.hap[v] == 2).tolist() == lin["second"][v].tolist()
        # a branch apart: every genome below one lineage, none of them a
        # carrier of the first
        two = lin["second"][v].tolist()
        paths = [_path(parent, lineage_of[j]) for j in range(cfg["samples"])]
        top = set.intersection(*(paths[j] for j in two))
        below = max(top, key=lambda l: len(_path(parent, l)))
        assert two == [j for j in range(cfg["samples"]) if below in paths[j]]
        assert not set(two) & set(np.flatnonzero(co.hap[v] == 1).tolist())


def test_lineage_panel_shape(haploid_cell, tmp_path):
    """Tens of alternates a genome, most sites rare, many singletons, and
    few distinct allele strings in a 35-bp window, as in a viral panel."""
    co = _cohort(haploid_cell, 13, tmp_path)
    per_col = (co.hap > 0).sum(axis=0)
    carriers = (co.hap > 0).sum(axis=1)
    assert 10 <= np.median(per_col) <= 100
    assert np.median(carriers) <= 3 and 0.2 < (carriers == 1).mean() < 0.6
    distinct = [np.unique(co.hap[i : np.searchsorted(co.pos0, co.pos0[i] + 35)], axis=1).shape[1]
                for i in range(0, co.hap.shape[0], 50)]
    assert np.median(distinct) < co.hap.shape[1] / 4


# SHA-256 of the FASTA, the inflated VCF and one donor's inflated FASTQ of
# the 1000 Genomes configuration at tiny_chr's size, as the generator wrote
# them before the lineage mode existed (deflate's own bytes depend on the
# zlib build, so the inflated text is compared).
CHR_DIGESTS = {
    1: ("4a7eb4828816e7b3167e5a1908d04a914624a0fa48abc8af0a059d8718bdf994",
        "cf5f077d766c2fc860b0190ad04f2af6e4f137a36954ec39a669df5d9d53c141",
        "586d80a5fbc2402f0883f597e00b7ca4b80d018a856f4d4b526ff64794586445"),
    2**33 + 7: ("24d74b9037c16b0d4cf6fcfdd0ccbd856a479e09ab1d686c32e5ddd39cb1a735",
                "1f60ba16808e122b10dff034e66b282b0bf0ce95add82a80603f11c4222da534",
                "d0cb1a93cb19d84978a4f15e953c4f8953d469cd7f4f3c745edae534583a88aa"),
    3_000_000_019: ("af3d744abb1071b46c29996c625d5adb68a7109cb25a1f997c366f47920b9dc0",
                    "236127c64c9850966ff556d9e1557954c8e27a871c6a87c67de9558c3bf0ffde",
                    "73cd8ddaa8a68f83aa326087cc88fed1a25a080f076696590f3fef31baffd60d"),
}


@pytest.mark.parametrize("seed", sorted(CHR_DIGESTS))
def test_chr_inputs_are_unchanged(chr_cell, seed, tmp_path):
    import hashlib

    cfg, wl = chr_cell
    co = _cohort(chr_cell, seed, tmp_path)
    rs = make_donor(co, pick_donors(co, 1, rng_for(seed, 1))[0], wl, rng_for(seed, 100),
                    str(tmp_path / "d.fq.gz"))
    with open(co.fasta, "rb") as f, gzip.open(co.vcf) as v, gzip.open(rs.path) as q:
        got = tuple(hashlib.sha256(b).hexdigest() for b in (f.read(), v.read(), q.read()))
    assert got == CHR_DIGESTS[seed] and co.lineages is None


def test_donor_reads(chr_cell, tmp_path):
    cfg, wl = chr_cell
    co = _cohort(chr_cell, 13, tmp_path)
    cols = pick_donors(co, 2, rng_for(13, 1))
    assert all(len(set(c)) == 2 for c in cols)
    rs = make_donor(co, cols[0], wl, rng_for(13, 2), str(tmp_path / "d.fq.gz"))
    n = round(wl["depth"] * cfg["length_bp"] / wl["read_length"])
    assert rs.reads.shape == (n, wl["read_length"])
    with gzip.open(rs.path, "rt") as f:
        lines = f.read().splitlines()
    assert len(lines) == 4 * n and lines[1].encode() == rs.reads[0].tobytes()
    assert k3_windows(rs.reads, 43) == n * (wl["read_length"] + 1) - 42
    # the donor's alternate alleles are in its reads: a read-length stretch
    # of a haplotype around an alternate SNP is found on one strand or the other
    h = haplotype(co, cols[0][0])
    assert h.shape[0] != co.genome.shape[0] or not np.array_equal(h, co.genome)
    text = b"".join(r.tobytes() for r in rs.reads)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    probe = h[1000:1030].tobytes()
    assert probe in text or probe.translate(comp)[::-1] in text


def test_error_rate(chr_cell, tmp_path):
    from h100bench.gen.reads import sequence

    co = _cohort(chr_cell, 14, tmp_path)
    clean = sequence([co.genome], 4000, 150, 0.0, rng_for(1, 1))
    noisy = sequence([co.genome], 4000, 150, 0.01, rng_for(1, 1))
    assert clean.shape == noisy.shape
    assert 0.005 < (clean != noisy).mean() < 0.015
