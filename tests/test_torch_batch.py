"""The port's ``batch`` (``call_batch`` and the CLI) against malva_tpu's
``call_batch`` with the host backend: per-sample VCFs byte-identical, with
one device-index upload for the whole batch."""

import io
import os
import shutil

import numpy as np
import pytest

import malva_tpu.pipeline as mp
from malva_tpu.utils.config import Config
from malva_tpu_torch import pipeline as tp
from malva_tpu_torch.index import device as tdev
from fuzz_gen import gen_case

D = os.path.join(os.path.dirname(__file__), "data", "diploid")


def _mutated_reads(tmp_path, src: str, n: int, seed: int) -> list[str]:
    """n read sets that differ from ``src`` and from each other in a few
    bases a read (tests/test_e2e_diploid.py:97-145)."""
    rng = np.random.default_rng(seed)
    lines = open(src, "rb").read().splitlines()
    paths = []
    for s in range(n):
        out = []
        for ln in lines:
            if ln.startswith(b">") or rng.random() > 0.5:
                out.append(ln)
                continue
            b = bytearray(ln)
            for _ in range(3):
                b[rng.integers(0, len(b))] = ord("ACGT"[rng.integers(0, 4)])
            out.append(bytes(b))
        p = tmp_path / f"s{s}.fa"
        p.write_bytes(b"\n".join(out) + b"\n")
        paths.append(str(p))
    return paths


def _case(name, tmp_path):
    if name == "diploid":
        fa, vcf, reads = (os.path.join(D, n) for n in ("ref.fa", "vars.vcf", "reads.fa"))
    else:
        fa, vcf, reads = gen_case(str(tmp_path), seed=43, n_samples=5, ref_len=5000, n_var=80,
                                  iupac_rate=0.01)
    return fa, vcf, _mutated_reads(tmp_path, reads, 2, seed=99)


@pytest.fixture
def uploads(monkeypatch):
    """Counts DeviceIndex.from_host calls."""
    calls = []
    real = tdev.DeviceIndex.from_host.__func__

    def counted(cls, *args, **kw):
        calls.append(args)
        return real(cls, *args, **kw)

    monkeypatch.setattr(tdev.DeviceIndex, "from_host", classmethod(counted))
    return calls


@pytest.mark.parametrize("case", ["diploid", "fuzz"])
@pytest.mark.parametrize("kmc", [False, True])
def test_call_batch_on_cpu_matches_host(case, kmc, tmp_path, uploads):
    fa, vcf, samples = _case(case, tmp_path)
    if kmc:  # the same samples as kmc_dump text (KMER<TAB>COUNT)
        dumps = []
        for i, s in enumerate(samples):
            keys, cnts = mp.count_reads_kmers(s, 43, log=open(os.devnull, "w"))
            p = tmp_path / f"d{i}.txt"
            p.write_text("".join(f"{k.tobytes().decode()}\t{c}\n" for k, c in zip(keys, cnts)))
            dumps.append(str(p))
        samples = dumps

    def cfg(backend):
        return Config(fasta_path=fa, vcf_path=vcf, sample_path=samples[0], bf_size=1 << 20,
                      backend=backend, from_kmc_dump=kmc)

    want = [io.StringIO() for _ in samples]
    mp.call_batch(cfg("host"), mp.build_index(cfg("host")), samples, want)
    got = [io.StringIO() for _ in samples]
    c = cfg("cuda")
    tp.call_batch(c, tp.build_index(c, device="cpu"), samples, got, device="cpu")
    assert len(uploads) == 1
    for g, w in zip(got, want):
        assert g.getvalue() == w.getvalue()
    assert got[0].getvalue() != got[1].getvalue()
    assert got[0].getvalue().count("\n") > 50


def test_batch_cli_matches_malva_tpu(tmp_path):
    """`malva-tpu-torch batch --backend host` == `malva-tpu batch --backend
    host`, file by file, with the same names for repeated basenames."""
    from malva_tpu import cli as mcli
    from malva_tpu_torch import cli as tcli

    fa, vcf, samples = _case("diploid", tmp_path)
    os.makedirs(tmp_path / "again")
    shutil.copy(samples[0], tmp_path / "again" / "s0.fa")
    samples.append(str(tmp_path / "again" / "s0.fa"))
    outs = {}
    for name, main in (("m", mcli.main), ("t", tcli.main)):
        work = tmp_path / name
        os.makedirs(work)
        for f in (fa, vcf):
            shutil.copy(f, work)
        args = ["batch", "--backend", "host", "-b", "1", "-o", str(work / "out"),
                str(work / "ref.fa"), str(work / "vars.vcf"), *samples]
        assert main(args) == 0
        outs[name] = {f: open(work / "out" / f).read() for f in sorted(os.listdir(work / "out"))}
    assert sorted(outs["t"]) == ["s0.1.malva.vcf", "s0.malva.vcf", "s1.malva.vcf"]
    assert outs["t"] == outs["m"]
    assert outs["t"]["s0.malva.vcf"] == outs["t"]["s0.1.malva.vcf"]
