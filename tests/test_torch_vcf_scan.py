"""The native VCF record scanner (``csrc/host_kernels.cpp`` VcfScan,
``pipeline._scanned_batches``) against the Python path it stands in for.

The same small VCFs, written here, go through both record sources batch
by batch: the batches' columns (the block boundaries and the contig each
block's reference comes from, contigs, positions, sizes, present flags,
alleles, frequencies and QUALs to the bit, IDs), their GT rows,
``used_out``, the Variants' fields, the extracted signatures and the
batch numbering under ``owned``.  The VCFs come as plain
text, one gzip member and many members with zero padding between them, and
cover symbolic and multi-allelic alternates, a missing ``-f`` key, ``.``
and unparseable frequency tokens, frequencies at float32 rounding ties,
``-u``, ``strip_chr`` and contig changes, absent records, haploid and
diploid columns, missing genotypes and GT in either place of FORMAT.  A
record the scanner leaves to Python, and a batch the GT parse rejects, go
the Python path; a truncated record, a bad POS, a bad QUAL and a bad GT
allele raise the same InputError on both routes, and the index's pass logs
the same "Processed N variants" heartbeat.
"""

import gzip
import io
import os
import zlib

import numpy as np
import pytest

from malva_tpu_torch import pipeline as tp
from malva_tpu_torch.io.fasta import load_reference
from malva_tpu_torch.utils import native
from malva_tpu_torch.utils.config import Config
from malva_tpu_torch.utils.errors import InputError
from malva_tpu_torch.utils.timing import PhaseTimer

pytestmark = pytest.mark.skipif(native.load() is None, reason="no native host library")

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)

# float32 rounding ties: the decimal above the midpoint of two float32s that
# rounds to the midpoint as a double, then to even as a float32 (strtof
# would round it up); and the midpoints themselves
TIES = ["0.50000002980232238769531251", "0.500000029802322387695312",
        "0.1000000052154064178466797", "0.30000001192092895507812501",
        "0.0078125000465661287307739"]


def _contigs(rng, names, length=1500):
    return {n: BASES[rng.integers(0, 4, size=length)].tobytes().decode() for n in names}


def _freq_token(rng, style):
    if style == "ties":
        return str(rng.choice(TIES))
    r = rng.random()
    if r < 0.55:
        return "%.4g" % rng.random()
    if r < 0.65:
        return "0"
    if r < 0.72:
        return "."
    if r < 0.77:
        return "abc"
    if r < 0.82:
        return "%.6e" % rng.random()
    if r < 0.86:
        return str(rng.choice(TIES))
    if r < 0.9:
        return str(rng.choice(["nan", "-inf", "1e-50", "+.5", "5.", "1E2"]))
    return "%.9f" % rng.random()


def _gt(rng, ploidy, n_alts):
    def allele():
        return "." if rng.random() < 0.05 else str(int(rng.integers(0, n_alts + 1)))

    if ploidy == 1:
        return allele()
    if rng.random() < 0.03:
        return ".|."
    return allele() + ("|" if rng.random() < 0.5 else "/") + allele()


def _records(rng, contigs, n, n_samples, *, ploidy=2, fmt="GT", style="mixed", key="AF",
             dense=0.5):
    """Random records over ``contigs`` (in order), each line's fields."""
    recs = []
    names = list(contigs)
    per = max(1, n // len(names))
    for ci, name in enumerate(names):
        seq = contigs[name]
        pos = 5
        for _ in range(per):
            pos += int(rng.integers(1, 6)) if rng.random() < dense else int(rng.integers(10, 60))
            if pos >= len(seq) - 30:
                break
            r = rng.random()
            ref = seq[pos - 1]
            if r < 0.6:
                alts = [b for b in "ACGT" if b != ref][: 1 if rng.random() < 0.85 else 2]
            elif r < 0.8:
                ref = seq[pos - 1 : pos + int(rng.integers(1, 5))]
                alts = [ref[0]]
            else:
                alts = [ref + "".join(rng.choice(list("ACGT"), size=int(rng.integers(1, 4))))]
            if rng.random() < 0.08:
                alts.insert(0 if rng.random() < 0.5 else len(alts), "<CN0>")
            if rng.random() < 0.03:
                alts = ["<DEL>"]
            if rng.random() < 0.1:
                ref = ref.lower()
            n_real = len([a for a in alts if not a.startswith("<")])
            toks = [_freq_token(rng, style) for _ in range(max(1, len(alts)))]
            if rng.random() < 0.1:
                info = "DP=10"  # no -f key
            elif rng.random() < 0.05:
                info = f"{key};DP=3"  # the key as a flag
            else:
                info = f"NS=3;{key}R=0.1;{key}=" + ",".join(toks) + ";DP=7"
            gts = [_gt(rng, ploidy or int(rng.integers(1, 3)), max(n_real, 1))
                   for _ in range(n_samples)]
            if fmt == "GT":
                f, smp = "GT", gts
            elif fmt == "GT:DP":
                f, smp = "GT:DP", [f"{g}:{int(rng.integers(0, 50))}" for g in gts]
            else:
                f, smp = "DP:GT", [f"{int(rng.integers(0, 50))}:{g}" for g in gts]
            qual = "." if rng.random() < 0.5 else "%.3g" % (rng.random() * 100)
            recs.append([name, str(pos), f"v{len(recs)}", ref, ",".join(alts) or ".", qual,
                         "PASS", info, f, *smp])
    return recs


def _write(path, contigs, recs, n_samples, form, vcf_names=None):
    head = ["##fileformat=VCFv4.1"]
    head += [f"##contig=<ID={n},length={len(s)}>" for n, s in contigs.items()]
    head.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(f"S{i}" for i in range(n_samples)))
    lines = [h.encode() for h in head] + ["\t".join(r).encode() for r in recs]
    text = b"\n".join(lines) + b"\n"
    vcf = str(path) + (".vcf.gz" if form != "plain" else ".vcf")
    with open(vcf, "wb") as f:
        if form == "plain":
            f.write(text)
        elif form == "gzip":
            f.write(gzip.compress(text))
        else:  # members of a few lines each, zero padding between some
            for i in range(0, len(lines), 7):
                c = zlib.compressobj(1, zlib.DEFLATED, 31)
                f.write(c.compress(b"\n".join(lines[i : i + 7]) + b"\n") + c.flush())
                if i % 2:
                    f.write(b"\0" * 3)
    fa = str(path) + ".fa"
    with open(fa, "w") as f:
        for n, s in contigs.items():
            f.write(f">{n}\n{s}\n")
    return fa, vcf


def _cfg(fa, vcf, **kw):
    return Config(fasta_path=fa, vcf_path=vcf, sample_path=fa, bf_size=1 << 20, **kw)


def _python_route(monkeypatch):
    monkeypatch.setattr(tp, "_open_scan", lambda *a: None)


def _route_batches(cfg, keep_absent, scanned: bool):
    """Each batch of one record source, its columns and GT rows; and
    used_out."""
    reader = tp.open_variant_reader(cfg.vcf_path, cfg.samples)
    ctx = tp._GtCtx(reader)
    used: list = []
    if scanned:
        scan = tp._open_scan(cfg, reader, ctx, keep_absent)
        assert scan is not None
        batches = tp._scanned_batches(cfg, scan, ctx, keep_absent, used, None)
    else:
        batches = tp._python_batches(cfg, reader, ctx, keep_absent, used, None)
    out = []
    for cols in batches:  # the GT step before the scanner's next scan
        assert cols.scanned == scanned and not cols.fallback
        gts = tp._gt_rows(cols, ctx)
        assert gts is not None
        out.append((cols, gts))
    return out, used


COLUMNS = ("blk_off", "blk_name", "pos", "ref_size", "min_size", "max_size", "present",
           "al_start", "al_off", "al_bytes", "id_off", "id_bytes")
FIELDS = ("seq_name", "ref_pos", "idx", "ref_sub", "alts", "ref_size", "min_size", "max_size",
          "has_alts", "is_present", "filt", "info", "coverages")


def _assert_same_batches(cfg, keep_absent):
    got, used_n = _route_batches(cfg, keep_absent, scanned=True)
    want, used_p = _route_batches(cfg, keep_absent, scanned=False)
    assert used_n == used_p
    assert len(got) == len(want)
    for (cn, gn), (cp, gp) in zip(got, want):
        assert cn.n_vars == cp.n_vars
        for f in COLUMNS:
            np.testing.assert_array_equal(getattr(cn, f), getattr(cp, f), err_msg=f)
        assert [cn.names[i] for i in cn.name] == [cp.names[i] for i in cp.name]
        for f in ("freq", "qual"):  # to the bit
            assert getattr(cn, f).tobytes() == getattr(cp, f).tobytes(), f
        for u, w in zip(gn, gp):  # rows, a1, a2, phase
            assert u.dtype == w.dtype
            np.testing.assert_array_equal(u, w)
    return sum(cols.n_vars for cols, _ in got)


def _flats(cfg, refs, keep_absent, owned=None):
    used: list = []
    timer = PhaseTimer("t", out=io.StringIO())
    with timer.recording():
        it = tp._iter_extract_batches(cfg, refs, keep_absent, used_out=used, owned=owned)
        res = [x if owned is not None else (None, x) for x in it]
    return res, used, timer.counters


def _assert_same_flats(cfg, refs, keep_absent, monkeypatch, owned=None):
    got, used_n, cn = _flats(cfg, refs, keep_absent, owned)
    with monkeypatch.context() as m:
        _python_route(m)
        want, used_p, cp = _flats(cfg, refs, keep_absent, owned)
    assert used_n == used_p
    assert [b for b, _ in got] == [b for b, _ in want]
    for (_, fn), (_, fp) in zip(got, want):
        for f in ("tgt_var", "tgt_allele", "tgt_nsig", "sig_nk", "kmer_len", "bytes"):
            np.testing.assert_array_equal(getattr(fn, f), getattr(fp, f))
        assert fn.n_vars == fp.n_vars == len(fn.all_vars)
        for x, y in zip(fn.all_vars, fp.all_vars):
            assert [getattr(x, f) for f in FIELDS] == [getattr(y, f) for f in FIELDS]
    return cn, cp


CASES = {
    # name -> (records kwargs, contigs, n_samples, config kwargs)
    "diploid": (dict(ploidy=2), ["c1"], 6, {}),
    "haploid": (dict(ploidy=1), ["c1"], 5, {}),
    "mixed ploidy": (dict(ploidy=0), ["c1"], 4, {}),
    "GT:DP": (dict(fmt="GT:DP"), ["c1"], 4, {}),
    "DP:GT": (dict(fmt="DP:GT"), ["c1"], 4, {}),
    "ties": (dict(style="ties"), ["c1"], 3, {}),
    "-u": (dict(), ["c1"], 3, dict(uniform=True)),
    "contigs": (dict(), ["c1", "c2", "c3"], 3, {}),
    "strip_chr": (dict(), ["chr1", "chr2"], 3, dict(strip_chr=True)),
    "-f other key": (dict(key="EUR_AF"), ["c1"], 3, dict(freq_key="EUR_AF")),
    "missing -f key": (dict(key="XX"), ["c1"], 3, {}),
    "sparse": (dict(dense=0.05), ["c1", "c2"], 2, {}),
}


@pytest.mark.parametrize("form", ["plain", "gzip", "members"])
@pytest.mark.parametrize("case", list(CASES))
def test_scan_matches_python_path(tmp_path, monkeypatch, case, form):
    """Batch by batch, both routes give the same variants, GT arrays,
    blocks, references, used_out and signatures, with batches of a few
    variants so that blocks and batches cross often."""
    kw, names, n_samples, ckw = CASES[case]
    rng = np.random.default_rng(zlib.crc32(f"{case}/{form}".encode()))
    contigs = _contigs(rng, names)
    recs = _records(rng, contigs, 90, n_samples, **kw)
    fa, vcf = _write(tmp_path / "v", contigs, recs, n_samples, form)
    cfg = _cfg(fa, vcf, **ckw)
    refs = load_reference(fa, cfg.strip_chr)
    monkeypatch.setattr(tp, "EXTRACT_VARS", 7)
    for keep_absent in (True, False):
        n = _assert_same_batches(cfg, keep_absent)
        assert n > 10 or (case == "missing -f key" and not keep_absent)  # all absent there
        cn, cp = _assert_same_flats(cfg, refs, keep_absent, monkeypatch)
        spans = "pass2" if keep_absent else "variants"
        assert cn.get(f"{spans}.native_records", 0) == cn.get(f"{spans}.records", 0) == n
        assert cp.get(f"{spans}.fallback_records", 0) == cp.get(f"{spans}.records", 0) == n
    _assert_same_flats(cfg, refs, True, monkeypatch, owned=lambda b: b % 3 == 1)


def test_used_out_quirk_and_absent_first_record(tmp_path, monkeypatch):
    """The first record's contig is recorded even when it enters no block,
    and a contig whose one variant never triggers a flush is not
    (pipeline._iter_blocks' state machine); absent records (AF 0) enter
    pass 2's blocks and not the index's."""
    contigs = {"a": "ACGT" * 100, "b": "ACGT" * 100, "c": "ACGT" * 100, "d": "ACGT" * 100}
    rows = [("a", 5, "A", "C", "AF=0"), ("b", 9, "A", "C", "AF=0.2"), ("b", 11, "A", "G", "AF=0"),
            ("c", 9, "A", "C", "AF=0.3"), ("d", 50, "G", "T", "AF=0.1"),
            ("d", 300, "G", "T", "AF=0.1")]
    recs = [[c, str(p), ".", r, a, ".", ".", i, "GT", "0|1", "1|1"] for c, p, r, a, i in rows]
    fa, vcf = _write(tmp_path / "q", contigs, recs, 2, "plain")
    cfg = _cfg(fa, vcf)
    refs = load_reference(fa)
    for keep_absent in (True, False):
        _assert_same_batches(cfg, keep_absent)
        _assert_same_flats(cfg, refs, keep_absent, monkeypatch)
    _, used, _ = _flats(cfg, refs, False)
    assert used[0] == "a"


def test_large_file_crosses_the_text_buffer(tmp_path, monkeypatch):
    """A VCF larger than the scanner's first text buffer (8 MiB): lines
    cross its refills, and batches its compaction, on both forms."""
    rng = np.random.default_rng(5)
    contigs = _contigs(rng, ["c1"], 60000)
    recs = _records(rng, contigs, 2000, 1, ploidy=2, dense=0.2)
    columns = [[_gt(rng, 2, 1) for _ in range(1400)] for _ in range(16)]
    recs = [r[:9] + columns[i % 16] for i, r in enumerate(recs)]
    for form in ("plain", "members"):
        fa, vcf = _write(tmp_path / form, contigs, recs, 1400, form)
        assert (os.path.getsize(vcf) > 8 << 20) == (form == "plain")
        cfg = _cfg(fa, vcf)
        monkeypatch.setattr(tp, "EXTRACT_VARS", 300)
        assert _assert_same_batches(cfg, True) > 1000


def _one_bad(tmp_path, bad_line, n_samples=2):
    contigs = {"c1": "ACGT" * 500}
    recs = [["c1", str(60 * i + 5), ".", "A", "C", ".", ".", "AF=0.2", "GT", "0|1", "1|0"]
            for i in range(30)]
    lines = ["\t".join(r) for r in recs]
    lines.insert(17, bad_line)
    text = "\n".join(lines)
    fa, vcf = _write(tmp_path / "bad", contigs, [], n_samples, "gzip")
    with gzip.open(vcf, "rb") as f:
        head = f.read()
    with open(vcf, "wb") as f:
        f.write(gzip.compress(head + text.encode() + b"\n"))
    return _cfg(fa, vcf), load_reference(fa)


@pytest.mark.parametrize("bad", [
    "c1\t100\t.\tA\tC\t.\t.",                                  # truncated record
    "c1\t1x0\t.\tA\tC\t.\t.\tAF=0.2\tGT\t0|1\t1|0",           # bad POS
    "c1\t100\t.\tA\tC\tq1\t.\tAF=0.2\tGT\t0|1\t1|0",          # bad QUAL
    "c1\t100\t.\tA\tC\t.\t.\tAF=0.2\tGT\t0|x\t1|0",           # bad GT allele
])
def test_errors_read_the_same(tmp_path, monkeypatch, bad):
    """A truncated record, a bad POS, a bad QUAL and a bad GT allele raise
    the same InputError text on the native route and the Python path."""
    cfg, refs = _one_bad(tmp_path, bad)
    msgs = []
    for python in (False, True):
        with monkeypatch.context() as m:
            if python:
                _python_route(m)
            with pytest.raises(InputError) as e:
                list(tp._iter_extract_batches(cfg, refs, keep_absent=True))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("odd", [
    "c1\t1025\tvé\tA\tC\t.\t.\tAF=0.2\tGT\t0|1\t1|0",      # non-ASCII ID
    "c1\t1025\t.\tA\tC\t.\t.\tAF= 0.2\tGT\t0|1\t1|0",           # a space in a frequency
    "c1\t1025\t.\tA\tC\t.\t.\tAF=0_2\tGT\t0|1\t1|0",            # '_' in a frequency
    "c1\t 1025\t.\tA\tC\t.\t.\tAF=0.2\tGT\t0|1\t1|0",           # a space in POS
    "c1\t1025\t.\tA\tC\t.\t.\tAF=0.2\tGT\t" + "|".join("0" * 65) + "\t1|0",  # ploidy 65
    "c1\t1025\t.\tA\tC\t.\t.\tAF=0.2\tGT\t0|1",                 # a sample short
])
def test_records_python_reads_take_the_python_path(tmp_path, monkeypatch, odd):
    """A record the scanner leaves to Python (non-ASCII, Python's wider
    number grammar) or a GT column its batch parse rejects sends its batch
    down the Python path, counted under fallback_records; the result is
    the Python path's, errors included."""
    cfg, refs = _one_bad(tmp_path, odd)
    monkeypatch.setattr(tp, "EXTRACT_VARS", 4)
    try:
        cn, cp = _assert_same_flats(cfg, refs, True, monkeypatch)
    except (InputError, IndexError) as e:  # the Python path's own verdict
        with monkeypatch.context() as m:
            _python_route(m)
            with pytest.raises(type(e)) as e2:
                list(tp._iter_extract_batches(cfg, refs, keep_absent=True))
        assert str(e2.value) == str(e)
        return
    assert 0 < cn["pass2.fallback_records"] < cn["pass2.records"]
    assert cn["pass2.native_records"] + cn["pass2.fallback_records"] == cn["pass2.records"]
    assert cp["pass2.fallback_records"] == cp["pass2.records"]


def test_stream_errors_read_as_gzips(tmp_path):
    """A gzip stream cut short or followed by garbage raises what Python's
    gzip raises on it."""
    cfg, refs = _one_bad(tmp_path, "c1\t1025\t.\tA\tC\t.\t.\tAF=0.2\tGT\t0|1\t1|0")
    data = open(cfg.vcf_path, "rb").read()
    for name, blob in (("cut", data[:-20]), ("garbage", data + b"xyz")):
        path = tmp_path / f"{name}.vcf.gz"
        path.write_bytes(blob)
        c = _cfg(cfg.fasta_path, str(path))
        with pytest.raises(Exception) as want:
            with gzip.open(path, "rb") as f:
                f.read()
        with pytest.raises(type(want.value)):
            list(tp._iter_extract_batches(c, refs, keep_absent=True))


def test_heartbeat_every_5000_records(tmp_path, monkeypatch):
    """The index's pass logs "Processed N variants" every 5,000 records on
    both routes, absent and symbolic records counted."""
    rng = np.random.default_rng(11)
    contigs = _contigs(rng, ["c1", "c2"], 160000)
    recs = _records(rng, contigs, 12000, 1, dense=0.9)
    assert len(recs) > 10000
    fa, vcf = _write(tmp_path / "hb", contigs, recs, 1, "gzip")
    cfg = _cfg(fa, vcf)
    refs = load_reference(fa)
    beats = []
    for python in (False, True):
        with monkeypatch.context() as m:
            if python:
                _python_route(m)
            timer = PhaseTimer("t", out=io.StringIO())
            list(tp._iter_extract_batches(cfg, refs, keep_absent=False, timer=timer))
        beats.append([ln.split("]")[0] for ln in timer.out.getvalue().splitlines()
                      if "Processed" in ln and "Execution Time" in ln])
    assert beats[0] == beats[1] == [f"[t/Processed {n} variants" for n in (5000, 10000)]


def _bcf_or_subset(tmp_path, form):
    """A seeded fuzz case as BCF, or as VCF under a ``--samples`` subset."""
    from fuzz_gen import gen_case

    fa, vcf, _ = gen_case(str(tmp_path), 403, n_samples=6)
    if form == "bcf":
        from malva_tpu_torch.io.bcf import write_bcf
        from malva_tpu_torch.io.vcf import VcfReader

        r = VcfReader(vcf)
        vcf = str(tmp_path / "vars.bcf")
        write_bcf(vcf, r.meta_lines, r.sample_names, list(r), freq_key="AF")
        return _cfg(fa, vcf)
    (tmp_path / "samples.txt").write_text("S1\nS4\nS2\n")
    return _cfg(fa, vcf, samples=str(tmp_path / "samples.txt"))


@pytest.mark.parametrize("case", [*CASES, "bcf", "samples subset"])
def test_the_library_extracts_every_batch(tmp_path, monkeypatch, case):
    """With the library loaded, every batch of either record source, BCF
    and a ``--samples`` subset included, goes through the one native
    extraction: ``VB.extract_kmers``, the extraction without the library,
    is never called."""
    from malva_tpu_torch.variants.blocks import VB

    def refused(*a, **kw):
        raise AssertionError("VB.extract_kmers called with the library loaded")

    monkeypatch.setattr(VB, "extract_kmers", refused)
    if case in CASES:
        kw, names, n_samples, ckw = CASES[case]
        rng = np.random.default_rng(zlib.crc32(f"{case}/extract".encode()))
        contigs = _contigs(rng, names)
        fa, vcf = _write(tmp_path / "v", contigs, _records(rng, contigs, 90, n_samples, **kw),
                         n_samples, "gzip")
        cfg = _cfg(fa, vcf, **ckw)
    else:
        cfg = _bcf_or_subset(tmp_path, case)
    refs = load_reference(cfg.fasta_path, cfg.strip_chr)
    monkeypatch.setattr(tp, "EXTRACT_VARS", 7)
    for python in (False, True):
        with monkeypatch.context() as m:
            if python:
                _python_route(m)
            for keep_absent in (True, False):
                _, _, c = _flats(cfg, refs, keep_absent)
                spans = "pass2" if keep_absent else "variants"
                if case != "missing -f key" or keep_absent:  # all absent there
                    assert c[f"{spans}.records"] > 10
                assert c.get(f"{spans}.extract_blocks", 0) > 0 or not c.get(f"{spans}.records")
