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
    f = body[0].split("\t")
    assert len(f) == 9 + cfg["samples"] and all(len(g) == 1 for g in f[9:])
    # the panel's AF is its own, not the columns': some sites have no carrier
    assert (co.hap.max(axis=1) == 0).any()


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
