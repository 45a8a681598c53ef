"""The port's ``index`` and ``call`` with the native record scan, with the
Python path, and malva_tpu's: the same VCF bytes and the same index.

On the diploid fixture, a seeded haploid case, a cohort of the
benchmark's generator (``h100bench/gen``) at 2,504 samples with its slice
cut to a few thousand bases, and the generator's SARS-CoV-2 lineage panel
cut to a test's size, whose records chain into one block.  The native
route counts every record under
``native_records``; BCF input and a ``--samples`` subset take the Python
path and count every record under ``fallback_records``.
"""

import io
import json
import os

import numpy as np
import pytest

import malva_tpu.pipeline as mp
from malva_tpu.utils.config import Config as MConfig
from malva_tpu_torch import pipeline as tp
from malva_tpu_torch.utils import native
from malva_tpu_torch.utils.config import Config as TConfig
from malva_tpu_torch.utils.timing import PhaseTimer
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


def _case(name, tmp_path):
    if name == "diploid":
        return tuple(os.path.join(D, n) for n in ("ref.fa", "vars.vcf", "reads.fa")), {}
    if name == "haploid":
        return gen_case(str(tmp_path), 402, haploid=True, n_samples=6), dict(haploid=True)
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


@pytest.mark.parametrize("case", ["diploid", "haploid", "cohort-2504", "lineage-panel"])
def test_native_scan_python_path_and_malva_tpu_agree(tmp_path, monkeypatch, case):
    (fa, vcf, reads), kw = _case(case, tmp_path)
    assert kw.get("haploid", False) == (case in ("haploid", "lineage-panel"))
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


@pytest.mark.parametrize("form", ["bcf", "samples subset"])
def test_bcf_and_sample_subsets_take_the_python_path(tmp_path, form):
    """BCF input (found by sniffing) and a ``--samples`` subset scan on the
    Python path: every record counts under ``fallback_records``."""
    fa, vcf, reads = gen_case(str(tmp_path), 403, n_samples=6)
    extra = {}
    if form == "bcf":
        from malva_tpu_torch.io.bcf import write_bcf
        from malva_tpu_torch.io.vcf import VcfReader

        r = VcfReader(vcf)
        vcf = str(tmp_path / "vars.bcf")
        write_bcf(vcf, r.meta_lines, r.sample_names, list(r), freq_key="AF")
    else:
        (tmp_path / "samples.txt").write_text("S1\nS4\nS2\n")
        extra = dict(samples=str(tmp_path / "samples.txt"))
    cfg = TConfig(fasta_path=fa, vcf_path=vcf, sample_path=reads, bf_size=1 << 22, **extra)
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
