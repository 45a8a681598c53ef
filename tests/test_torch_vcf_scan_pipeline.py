"""The port's ``index`` and ``call`` with the native record scan, with the
Python path, and malva_tpu's: the same VCF bytes and the same index.

On the diploid fixture, a seeded haploid case, a cohort of the
benchmark's generator (``h100bench/gen``) at 2,504 samples with its slice
cut to a few thousand bases, and the generator's SARS-CoV-2 lineage panel
cut to a test's size, whose records chain into one block, and dense
fuzz cases that chain too, diploid (phased and unphased) and haploid.
A block of more than 64 records runs as a unit of work for each 64: its
flat outputs against the same block cut by hand and against malva_tpu's
library, which extracts it whole.  The native
route counts every record under
``native_records``; BCF input and a ``--samples`` subset take the Python
path, count every record under ``fallback_records`` and give malva_tpu's
VCF.
"""

import functools
import io
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

import malva_tpu.pipeline as mp
from malva_tpu.utils.config import Config as MConfig
from malva_tpu_torch import pipeline as tp
from malva_tpu_torch.utils import native
from malva_tpu_torch.utils.config import Config as TConfig
from malva_tpu_torch.utils.timing import PhaseTimer
import fuzz_gen
from fuzz_gen import gen_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = os.path.join(REPO, "tests", "data", "diploid")

pytestmark = pytest.mark.skipif(native.load() is None, reason="no native host library")


def _generated(tmp_path, name, cut, depth, seed):
    """A deployment of the benchmark's generator, ``cut`` to a test's size,
    and one donor's reads."""
    from h100bench.gen.cohort import freq_key, make_cohort
    from h100bench.gen.reads import make_donor, pick_donors

    with open(os.path.join(REPO, "h100bench", "configs", f"{name}.json")) as f:
        conf = json.load(f)
    conf.update(cut)
    cohort = make_cohort(conf, seed, str(tmp_path))
    rng = np.random.default_rng(7)
    work = {"read_length": 150, "depth": depth, "error_rate": 0.001}
    reads = make_donor(cohort, pick_donors(cohort, 1, rng)[0], work, rng,
                       str(tmp_path / "donor.fq.gz")).path
    return (cohort.fasta, cohort.vcf, reads), dict(
        freq_key=freq_key(conf), verbose=True, haploid=cohort.ploidy == 1)


def _chained(tmp_path, monkeypatch, seed, **kw):
    """A fuzz case whose records all lie 1-7 bp after the last, so that
    they chain into one block."""
    with monkeypatch.context() as m:
        m.setattr(fuzz_gen, "gen_variants",
                  functools.partial(fuzz_gen.gen_variants, dense_frac=1.0))
        return gen_case(str(tmp_path), seed, n_samples=6, ref_len=2000, **kw)


def _case(name, tmp_path, monkeypatch):
    if name == "diploid":
        return tuple(os.path.join(D, n) for n in ("ref.fa", "vars.vcf", "reads.fa")), {}
    if name == "haploid":
        return gen_case(str(tmp_path), 402, haploid=True, n_samples=6), dict(haploid=True)
    if name == "diploid-chain":
        # 200 records 1-7 bp apart, phased and unphased: one block of
        # three chunks of 64 and one of 8
        return _chained(tmp_path, monkeypatch, 404, n_var=200), {}
    if name == "haploid-chain":
        # 129 records: two chunks of 64 and one of a single record
        return _chained(tmp_path, monkeypatch, 405, haploid=True, n_var=129), dict(haploid=True)
    if name == "lineage-panel":
        # as h100bench/tests/conftest.py tiny_haploid cuts it: the panel's
        # density (a record per 2 bp) over 6,000 bp, 400 genomes of 48 lineages
        with open(os.path.join(REPO, "h100bench", "configs", "sarscov2-panel.json")) as f:
            lineages = dict(json.load(f)["lineages"], n_lineages=48)
        return _generated(tmp_path, "sarscov2-panel", {
            "length_bp": 6000, "records": 3000, "samples": 400, "lineages": lineages},
            40, 3220000001)
    return _generated(tmp_path, "chr20-1kgp3", {"length_bp": 4000}, 10, 3180000001)


def _port(cfg, tmp_path, tag, python_route, monkeypatch):
    with monkeypatch.context() as m:
        if python_route:
            m.setattr(tp, "_open_scan", lambda *a: None)
        timer = PhaseTimer("t", out=io.StringIO())
        with timer.recording():
            index = tp.build_index(cfg, timer=timer)
            path = str(tmp_path / f"{tag}.npz")
            tp.save_index(index, path, cfg)
            out = io.StringIO()
            tp.call(cfg, tp.load_index(path), out, timer=timer)
    return out.getvalue(), dict(np.load(path)), timer.counters


@pytest.mark.parametrize("case", ["diploid", "haploid", "cohort-2504", "lineage-panel",
                                  "diploid-chain", "haploid-chain"])
def test_native_scan_python_path_and_malva_tpu_agree(tmp_path, monkeypatch, case):
    (fa, vcf, reads), kw = _case(case, tmp_path, monkeypatch)
    assert kw.get("haploid", False) == (case in ("haploid", "lineage-panel", "haploid-chain"))
    args = dict(fasta_path=fa, vcf_path=vcf, sample_path=reads, bf_size=1 << 22, **kw)
    cfg = TConfig(**args)
    got, got_ix, counters = _port(cfg, tmp_path, "native", False, monkeypatch)
    want, want_ix, fb = _port(cfg, tmp_path, "python", True, monkeypatch)
    assert got.count("\n") > 20
    assert got == want
    assert got_ix.keys() == want_ix.keys()
    for k in got_ix:
        np.testing.assert_array_equal(got_ix[k], want_ix[k])
    for spans in ("pass2", "variants"):
        assert counters[f"{spans}.native_records"] == counters[f"{spans}.records"] > 0
        assert f"{spans}.fallback_records" not in counters
        assert fb[f"{spans}.fallback_records"] == fb[f"{spans}.records"]
        if case == "lineage-panel":  # every record chains into one block
            assert counters[f"{spans}.extract_blocks"] == fb[f"{spans}.extract_blocks"] == 1
        if case in ("lineage-panel", "diploid-chain", "haploid-chain"):
            # a block of more than 64 records runs as a unit for each 64
            assert counters[f"{spans}.extract_units"] > counters[f"{spans}.extract_blocks"]
    mcfg = MConfig(**args)
    m_index = mp.build_index(mcfg)
    m_path = str(tmp_path / "malva_tpu.npz")
    mp.save_index(m_index, m_path, mcfg)
    out = io.StringIO()
    mp.call(mcfg, mp.load_index(m_path), out)
    assert out.getvalue() == got
    m_ix = dict(np.load(m_path))
    for k in set(m_ix) - {"meta_json"}:
        np.testing.assert_array_equal(m_ix[k], got_ix[k])


@pytest.mark.parametrize("form", ["bcf", "samples subset", "ploidy-1 samples subset"])
def test_bcf_and_sample_subsets_take_the_python_path(tmp_path, form):
    """BCF input (found by sniffing) and a ``--samples`` subset scan on the
    Python path: every record counts under ``fallback_records``, and the
    VCF is malva_tpu's.  Ploidy-1 columns genotyped diploid read each
    sample's second allele from the next selected sample (upstream's
    wrap-around)."""
    fa, vcf, reads = gen_case(str(tmp_path), 403, n_samples=6, haploid=form.startswith("ploidy-1"))
    extra = {}
    if form == "bcf":
        from malva_tpu_torch.io.bcf import write_bcf
        from malva_tpu_torch.io.vcf import VcfReader

        r = VcfReader(vcf)
        vcf = str(tmp_path / "vars.bcf")
        write_bcf(vcf, r.meta_lines, r.sample_names, list(r), freq_key="AF")
    else:
        (tmp_path / "samples.txt").write_text("S1\nS4\nS2\n")
        extra["samples"] = str(tmp_path / "samples.txt")
    args = dict(fasta_path=fa, vcf_path=vcf, sample_path=reads, bf_size=1 << 22, **extra)
    cfg = TConfig(**args)
    timer = PhaseTimer("t", out=io.StringIO())
    with timer.recording():
        index = tp.build_index(cfg, timer=timer)
        out = io.StringIO()
        tp.call(cfg, index, out, timer=timer)
    c = timer.counters
    assert out.getvalue().count("\n") > 20
    for spans in ("pass2", "variants"):
        assert c[f"{spans}.fallback_records"] == c[f"{spans}.records"] > 0
        assert f"{spans}.native_records" not in c
    mcfg = MConfig(**args)
    want = io.StringIO()
    mp.call(mcfg, mp.build_index(mcfg), want)
    assert out.getvalue() == want.getvalue()


def _run_variants(rng, ref: bytes, runs, n_ind: int):
    """Variants in ``runs`` of (start, count), a run's records 1-5 bp apart:
    SNPs (a fifth with a second ALT), deletions that overlap the next
    records, a few records absent from the cohort, GT indices past the
    ALTs, phased and unphased genotypes."""
    out = []
    for start, count in runs:
        pos = start
        for _ in range(count):
            pos += int(rng.integers(1, 6))
            ref_sub = ref[pos:pos + 1]
            if rng.random() < 0.15:
                ref_sub, alts = ref[pos:pos + 1 + int(rng.integers(1, 5))], [ref_sub]
            else:
                alts = [b for b in (b"A", b"C", b"G", b"T") if b != ref_sub]
                alts = alts[:2 if rng.random() < 0.2 else 1]
            n_al = 1 + len(alts)
            a1, a2 = (np.where(rng.random(n_ind) < 0.6, 0, rng.integers(1, n_al, n_ind))
                      .astype(np.int32) for _ in range(2))
            if rng.random() < 0.05:
                a1[int(rng.integers(n_ind))] = n_al
            sizes = [len(a) for a in (ref_sub, *alts)]
            out.append(SimpleNamespace(
                seq_name="ctg", ref_pos=pos, idx=".", ref_size=len(ref_sub),
                min_size=min(sizes), max_size=max(sizes), quality=np.float32("nan"),
                is_present=bool(rng.random() > 0.05), ref_sub=ref_sub, alts=alts,
                frequencies=[np.float32(1 / n_al)] * n_al,
                gt_a1=a1, gt_a2=a2, phase=rng.random(n_ind) < 0.5))
    return out


def _extract(monkeypatch, blocks, haploid):
    """The port's extraction (native.extract_columns) over ``blocks``,
    [(variants, ref), ...], laid out as columns by the Python path's
    builder, the present variants' GT arrays as rows -> (its six arrays,
    the first variant with an allele past its ALTs, its stats)."""
    from malva_tpu_torch.variants.variant import to_columns

    cols = to_columns([(vs, [None] * len(vs), "ctg") for vs, _ in blocks])
    present = [v for v in cols.variants() if v.is_present]
    rows = np.full(cols.n_vars, -1, dtype=np.int64)
    rows[cols.present.astype(bool)] = np.arange(len(present))
    gts = (rows, *(np.stack([getattr(v, f) for v in present])
                   for f in ("gt_a1", "gt_a2", "phase")))
    seen = []
    extract_arrays = native.extract_arrays

    def recorded(*args, **kw):
        seen.append(extract_arrays(*args, **kw))
        return seen[-1]

    with monkeypatch.context() as m:
        m.setattr(native, "extract_arrays", recorded)
        res = native.extract_columns(cols, gts, {"ctg": blocks[0][1]}, 35, haploid)
    assert res is not None and len(seen) == 1
    oob, out, stats = seen[0]
    return out, oob, stats


def _assert_same(got, want):
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("haploid", [False, True])
def test_long_block_extracts_as_the_block_cut_at_64_by_hand(monkeypatch, haploid):
    """A block of 205 variants in runs of 64, 64, 64 and 13 that no
    combination spans (the runs 1,000 bp apart) runs as four units from
    the GT columns; cut by hand into four blocks, each runs whole from
    its profile matrix.  The flat outputs and the out-of-range variant
    are the same."""
    rng = np.random.default_rng(3230000017)
    ref = bytes(rng.choice(list(b"ACGT"), 5000).astype(np.uint8))
    vs = _run_variants(rng, ref, [(100 + 1000 * g, n) for g, n in enumerate((64, 64, 64, 13))],
                       7)
    got, got_oob, got_stats = _extract(monkeypatch, [(vs, ref)], haploid)
    want, want_oob, want_stats = _extract(
        monkeypatch, [(vs[i:i + 64], ref) for i in range(0, len(vs), 64)], haploid)
    assert (got_stats["blocks"], got_stats["units"]) == (1, 4)
    assert (want_stats["blocks"], want_stats["units"]) == (4, 4)
    assert got[0].size > 200
    _assert_same(got, want)
    assert got_oob == want_oob >= 0


@pytest.mark.parametrize("haploid", [False, True])
def test_chained_block_extracts_as_malva_tpu(monkeypatch, haploid):
    """One chained block of 150 variants (two chunks of 64 and one of 22)
    gives malva_tpu's flat outputs byte for byte: its library extracts
    the block whole, on one thread."""
    from malva_tpu.utils import native as m_native

    rng = np.random.default_rng(3230000019)
    ref = bytes(rng.choice(list(b"ACGT"), 2000).astype(np.uint8))
    vs = _run_variants(rng, ref, [(100, 150)], 7)
    got, _, stats = _extract(monkeypatch, [(vs, ref)], haploid)
    assert (stats["blocks"], stats["units"]) == (1, 3)
    assert got[0].size > 100
    _assert_same(got, m_native.extract_group([(vs, ref)], 35, haploid))
